// Batched greedy-NMS keep mask for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rs_face_detection_tpu/ops/nms_pallas.py::
// nms_mask_pallas (body _nms_kernel).  Same contract, batched over images:
// boxes (B, K, 4) f32 sorted by descending score per image, valid (B, K) u8,
// keep (B, K) u8.  Box i < j suppresses box j iff both are valid and their
// "+1"-area IoU is > thr; keep[j] = valid[j] and no KEPT box i < j suppresses
// j.  That is exactly greedy NMS (ops/nms.py::nms_mask_greedy).
//
// What bounds it on this card: not bytes or FLOPs -- at the main path's
// K = 128 an image holds at most K^2/2 = 8k IoUs and 2.5 KB of input.  The
// cost is the launch itself, the latency of each phase, and the greedy
// scan, a chain of dependent steps as long as the boxes it keeps.
// What the design does about it (one launch for the batch, one CTA per
// image, 1024 threads):
//   * phase 0 loads the boxes, computes each box's area and NaN test once,
//     packs valid bits by warp ballots, and reduces them to n = 1 + the index
//     of the last valid box.  Rows and columns >= n are never computed (on
//     every caller the valid rows are a prefix, mostly short at the main
//     path's 0.7 score threshold, but n is exact for any mask);
//   * phase 1 builds the suppression rows 32 columns at a time: each lane of
//     a warp computes one IoU of row i and __ballot_sync packs the 32
//     results, two ballots making the 64-bit word the scan reads.  Only the
//     chunks from i's own to the last below n are computed, and rows go to
//     warps in a zigzag (warp g takes rows g, 2W-1-g, 2W+g, ...), which
//     spreads the triangle evenly;
//   * phase 2, one warp: for each 64-box word w, the candidates are the valid
//     boxes of w not yet removed; the lowest is kept, its row's word w takes
//     out the candidates it suppresses (each lane ORs its own word of the
//     removed set), and the next kept box is the lowest still standing.  The
//     steps number the kept boxes plus the words, not K.
// This is the two-phase bitmask design of the classic CUDA NMS kernel, with
// the host-side scan moved onto the device.  It is not a block-by-block copy
// of the Pallas fixed-point iteration.
//
// Two measurement switches, never set in the library's build: chip_smoke.py
// builds variants with RSFD_NMS_NO_PHASE1 (phase 1 writes no row) and
// RSFD_NMS_NO_SCAN (no scan; keep is garbage) to show where the time goes.
//
// Numerics are bit-exact with ops/nms.py::_suppression_matrix: the same
// operation order, every product and sum rounded on its own (explicit _rn
// intrinsics, and the file is built with -fmad=false), a clamp at 0 that
// keeps a NaN as torch.clamp does, and a NaN coordinate never suppresses nor
// is suppressed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 1024;  // ceil(K/64) <= 16 words: one warp holds a row
constexpr int kMaxWords = kMaxK / 64;
constexpr int kMaxChunks = kMaxK / 32;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kWarps == 32, "n is reduced over one warp, a lane per warp");

size_t smem_bytes(int K) {
  // boxes (K float4), rows (K x ceil(K/64) u64), areas (K f32).
  return (sizeof(float4) + sizeof(unsigned long long) * ((K + 63) / 64) + sizeof(float)) * (size_t)K;
}

// max(d, 0) that keeps a NaN, as torch.clamp(min=0) and jnp.maximum do
// (fmaxf would drop it; inf - inf in a clamp makes one).
__device__ __forceinline__ float clamp0(float d) { return d < 0.0f ? 0.0f : d; }

// IoU(a, b) > thr for boxes with no NaN coordinate, in the reference's order.
__device__ __forceinline__ bool suppresses(float4 a, float area_a, float4 b, float area_b,
                                           float thr) {
  const float iw = clamp0(__fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 1.0f));
  const float ih = clamp0(__fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 1.0f));
  const float inter = __fmul_rn(iw, ih);
  // Exact shortcut.  inter = +-0 makes the IoU +-0 / d, which is +-0 for any
  // nonzero d (infinite too) and NaN for d = 0 or NaN; none of +-0 and NaN
  // is > thr when thr >= 0.  So the division is skipped there.
  if (inter == 0.0f && thr >= 0.0f) return false;
  return __fdiv_rn(inter, __fsub_rn(__fadd_rn(area_a, area_b), inter)) > thr;
}

// minBlocksPerSM 1: without it ptxas aims at two CTAs per SM, caps the
// kernel at 32 registers and spills.
__global__ void __launch_bounds__(kThreads, 1)
nms_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_box = reinterpret_cast<float4*>(smem);
  uint32_t* s_rows = reinterpret_cast<uint32_t*>(s_box + K);  // 16-byte aligned
  float* s_area = reinterpret_cast<float*>(s_rows + (size_t)2 * K * ((K + 63) / 64));
  __shared__ uint32_t s_valid[kMaxChunks];  // bit j of chunk c: box 32c + j is valid
  __shared__ uint32_t s_ok[kMaxChunks];     // ... and has no NaN coordinate
  __shared__ int s_last[kWarps];
  __shared__ unsigned long long s_kept[kMaxWords];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t img = blockIdx.x;
  const float* g_box = boxes + img * K * 4;
  const uint8_t* g_valid = valid + img * K;

  // Phase 0: boxes, areas and the bit sets, over whole 64-box words (bits
  // past K are 0); n = 1 + the last valid index.
  int last = -1;
  for (int base = 32 * warp; base < 64 * ((K + 63) / 64); base += kThreads) {
    const int j = base + lane;
    bool v = false, ok = false;
    if (j < K) {
      const float4 b = make_float4(g_box[4 * j], g_box[4 * j + 1], g_box[4 * j + 2], g_box[4 * j + 3]);
      s_box[j] = b;
      s_area[j] = __fmul_rn(__fadd_rn(__fsub_rn(b.z, b.x), 1.0f), __fadd_rn(__fsub_rn(b.w, b.y), 1.0f));
      v = g_valid[j] != 0;
      ok = v && !(isnan(b.x) || isnan(b.y) || isnan(b.z) || isnan(b.w));
    }
    const uint32_t vb = __ballot_sync(kFull, v);
    const uint32_t ob = __ballot_sync(kFull, ok);
    if (lane == 0) {
      s_valid[base >> 5] = vb;
      s_ok[base >> 5] = ob;
    }
    if (vb) last = base + 31 - __clz(vb);
  }
  if (lane == 0) s_last[warp] = last;
  __syncthreads();
  const int n = 1 + __reduce_max_sync(kFull, s_last[lane]);  // kWarps == 32 lanes
  const int chunks = (n + 31) >> 5;
  const int words = (n + 63) >> 6;  // row stride in u64: rows are packed by n

  // Phase 1: word c of row i (32 bits) holds bit jj for j = 32c + jj when i
  // suppresses j.  Written from i's own chunk (bits <= i are 0) to the last
  // chunk below n; the scan reads no bit <= i of row i.
#ifndef RSFD_NMS_NO_PHASE1
  for (int k = 0;; ++k) {
    const int i = kWarps * k + ((k & 1) ? kWarps - 1 - warp : warp);
    if (i >= n) break;
    if (!((s_valid[i >> 5] >> (i & 31)) & 1u)) continue;  // never read by the scan
    const bool ok_i = (s_ok[i >> 5] >> (i & 31)) & 1u;
    const float4 a = s_box[i];
    const float area_a = s_area[i];
    uint32_t* row = s_rows + (size_t)2 * words * i;
    for (int c = i >> 5; c < chunks; ++c) {
      const int j = 32 * c + lane;
      const bool s = ok_i && j > i && ((s_ok[c] >> lane) & 1u) &&
                     suppresses(a, area_a, s_box[j], s_area[j], thr);
      const uint32_t bits = __ballot_sync(kFull, s);
      if (lane == 0) row[c] = bits;
    }
  }
#endif
  __syncthreads();

  // Phase 2: warp 0 scans the kept boxes only.  Lane L holds word L of the
  // removed set.  In word w, `cand` is the valid boxes still standing above
  // the last one kept: the lowest is kept, its row's word w takes out the
  // candidates it suppresses, and lanes L > w OR in its word L.  The bits a
  // row leaves unwritten lie at or below i (every candidate is above i) or
  // at or past n (no box there is valid): none reaches a kept bit.
#ifndef RSFD_NMS_NO_SCAN
  if (warp == 0) {
    const unsigned long long* rows = reinterpret_cast<const unsigned long long*>(s_rows);
    unsigned long long removed = 0ull;
    for (int w = 0; w < words; ++w) {
      const unsigned long long valid_w =
          (unsigned long long)s_valid[2 * w] | ((unsigned long long)s_valid[2 * w + 1] << 32);
      unsigned long long cand = valid_w & ~__shfl_sync(kFull, removed, w);
      unsigned long long kept = 0ull;
      while (cand) {
        const unsigned long long low = cand & (0ull - cand);
        const unsigned long long* row = rows + (size_t)words * (64 * w + __ffsll(cand) - 1);
        const unsigned long long diag = row[w];
        if (lane > w && lane < words) removed |= row[lane];
        kept |= low;
        cand = (cand ^ low) & ~diag;
      }
      if (lane == 0) s_kept[w] = kept;
    }
  }
#endif
  __syncthreads();

  uint8_t* g_keep = keep + img * K;
  for (int j = threadIdx.x; j < K; j += kThreads) {
    g_keep[j] = j < n ? (uint8_t)((s_kept[j >> 6] >> (j & 63)) & 1ull) : (uint8_t)0;
  }
}

}  // namespace

extern "C" {

int rsfd_nms_max_k() { return kMaxK; }

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int rsfd_nms_mask(const float* boxes, const uint8_t* valid, uint8_t* keep,
                  int B, int K, float thr, void* stream) {
  if (B <= 0 || K <= 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K);
  if (smem > 48 * 1024) {
    // The opt-in above 48 KB, made once per device, for the largest K.
    static unsigned long long opted = 0ull;  // bit d: device d is done
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (!(opted & bit)) {
      err = cudaFuncSetAttribute(nms_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_bytes(kMaxK));
      if (err != cudaSuccess) return (int)err;
      opted |= bit;
    }
  }
  nms_mask_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      boxes, valid, keep, K, thr);
  return (int)cudaGetLastError();
}

}  // extern "C"
