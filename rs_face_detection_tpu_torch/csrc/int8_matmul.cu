// Int8 dequant-matmul for Hopper (sm_90a): K3.
//
// Replaces rs_face_detection_tpu/ops/quantize.py:210 int8_matmul (body
// _int8_matmul_kernel :201-206): out (M, N) f32 = x (M, K) @ (q (K, N) int8 *
// scale (N,)), the weight dequantized on chip, so no float copy of it ever
// exists in device memory.  Two arithmetics, picked per call:
//   f32:  x @ (float(q) * s) as JAX's weight-only FaceExtraction computes it
//         (dequantize_tree, then a Dense in f32);
//   bf16: the TPU kernel's rounding chain: x rounded to bf16, w = bf16(q) *
//         bf16(s) rounded to bf16, the products (exact in f32) summed in f32.
//
// What bounds it on this card.  At IResNet-50's fc, (8, 25088, 512), q is
// 12.85 MB, x 0.80 MB, scale and output 0.02 MB: 13.67 MB, 4.08 us at
// 3.35 TB/s.  The products below are 2 K N x 24 columns = 0.62 GFLOP of bf16
// tensor-core work (0.6 us at 989 TFLOP/s), so the int8 weight stream bounds
// it.  At M = 1 the bound is the 12.85 MB of q alone, 3.84 us.
//
// What the design does about it.
//   * The scale leaves the inner loop (f32 mode): out[m, n] = s_n * sum_k
//     x_mk q_kn.  Each |q| <= 127 is exact in bf16, so q widens with no I2F:
//     a byte permute gathers two bytes into the low bytes of a bf16x2 word,
//     (w & 0x7f) | 0x4300 is bf16 128 + (v & 127), (w & 0x80) | 0x4300 is
//     128 + (v & 128), and one bf16x2 subtraction of the two gives v exactly.
//   * The products run on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
//     accumulators), exactly: x is split into three bf16 parts, hi = bf16(x),
//     mid = bf16(x - hi), lo = bf16(x - hi - mid) (each difference is exact
//     in f32), so every product of a part and an integer q is exact in f32
//     and only the accumulation rounds.  The A operand is a 16 (n) x 16 (k)
//     tile of q taken transposed; B holds the x parts, k x 8 columns: at
//     M > 1 one n8 tile per part (column = row of x), at M = 1 one tile whose
//     columns 0-2 are the parts.  x's chunk is split once per CTA, into
//     the B fragments' order in shared memory.  In bf16 mode x goes in as
//     one part and the weight is formed in registers, bf16(q) * bf16(s) by
//     one bf16x2 multiply (rounded once, as the TPU rounds it).
//   * Each mma's f32 accumulation may truncate; a warp's chain is the
//     k-steps of its chunk that it owns, at most 16 (a chunk is at most 1024
//     rows, four warps share its k-steps), and the partial sums are added in
//     f32 in a fixed order (tests/test_torch_quantize.py emulates it).
//   * q streams through a ring of 8 shared-memory stages of 128 rows x 128
//     columns by 16-byte cp.async (two copies per thread per stage,
//     zero-filled past K and N).  x's chunk goes first, with q's first stage
//     only; then two more stages, and the loop keeps three in flight beyond
//     the one consumed (48 KB): issued all at once, the copies of a whole
//     chunk stall the issuing threads until most of it has landed, and no
//     work overlaps the stream; issued with more of q, x lands with q's last
//     bytes.  Each stage has an mbarrier that its copies complete
//     (cp.async.mbarrier.arrive) and one that the 16 warps arrive on once
//     they have consumed it, so warps never wait for each other in the
//     loop.  A q that is not 16-byte aligned, or N % 16 != 0, takes byte
//     loads into the same ring.
//   * Split-K in one launch.  The grid is (N / 128 column tiles) x (K chunks)
//     x (M / 8 row tiles), one CTA of 16 warps per SM (4 column slices of 32
//     x 4 warps along K).  The chunks of a column tile form thread-block
//     clusters of 2 or 4 (the wrapper's plan): rank r of a cluster owns a
//     1/cl share of the output tile; each CTA pushes its partial tile, share
//     by share, into the shared memory of the share's owner, and after one
//     cluster barrier each rank adds its rows in rank order.  With more
//     than one cluster per tile, each rank writes its share to a workspace
//     and bumps an arrival counter; the last of them sums the clusters'
//     shares in cluster order, writes the output and resets the counter.
//     No float atomics: a repeated call gives the same bits.  The counters
//     are a static array (zero at load, left zero by every call), one slot
//     of them per stream, picked by the wrapper.
//
// Shared memory (dynamic): the ring, each stage 128 rows of q, row r's
// 16-byte chunk c at position c ^ ((r >> 1) & 6) so the 32 lanes of a warp
// read 32 distinct banks; x's chunk, MT rows kc | 16 floats apart (16 mod
// 32: the two rows a quarter warp reads fall in the two halves of the
// banks); its bf16 parts as B fragments, each lane's two registers one
// 8-byte load; the cluster's receive buffer.  The epilogue reuses the ring
// for the warps' partial sums.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;                         // columns per CTA
constexpr int kSlices = kBN / 32;                // column slices of 32, one per warp: 4
constexpr int kKGroups = kWarps / kSlices;       // warps along K: 4
constexpr int kStep = 16;                        // rows per k-step (one mma)
constexpr int kStepsPerWarp = 2;                // k-steps of a warp per stage
constexpr int kStageRows = kKGroups * kStepsPerWarp * kStep;  // 128
constexpr int kStageBytes = kStageRows * kBN;    // 16 KB
constexpr int kCopies = kStageBytes / (16 * kThreads);        // 16-byte copies per thread per stage: 2
constexpr int kStages = 8;                       // the ring
constexpr int kAhead = 3;                        // stages in flight beyond the one consumed
constexpr int kMaxKC = 1024;                     // rows per K chunk, at most
constexpr int kMaxCluster = 4;
constexpr int kRedPitch = kBN + 4;               // floats per row of the warps' partial sums
constexpr int kSlots = 32;                       // counter slots (streams)
constexpr int kSlotCounters = 8192;              // counters per slot: column tiles x row tiles x cluster

static_assert(kCopies * 16 * kThreads == kStageBytes, "whole 16-byte copies per stage");
static_assert(kKGroups * 8 * kRedPitch * 4 <= kStages * kStageBytes, "the epilogue fits in the ring");

// Arrival counters of the clusters of one output tile.  Zero when the module
// loads; the last arrival of every call resets its counter.
__device__ unsigned int g_arrivals[kSlots * kSlotCounters];

// Measurement switch (built by chip_smoke.py, never loaded by the port):
// with RSFD_K3_TIMELINE, thread 0 of every CTA stamps %globaltimer at the
// kernel's phase boundaries into g_timeline[cta][point] (kMarks points: 0
// start, 1 x landed, 2 x split, 3 loop done, 4 cluster summed, 5 arrival
// counted, 6 output written, the last only by the CTAs that write).
#ifdef RSFD_K3_TIMELINE
constexpr int kMarks = 7;
__device__ unsigned long long g_timeline[65536 * kMarks];
#define K3_MARK(k)                                                                                       \
  do {                                                                                                   \
    if (threadIdx.x == 0) {                                                                              \
      unsigned long long t_;                                                                             \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                                             \
      const unsigned cta_ = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);             \
      if (cta_ < 65536) g_timeline[cta_ * kMarks + (k)] = t_;                                            \
    }                                                                                                    \
  } while (0)
#else
#define K3_MARK(k) \
  do {             \
  } while (0)
#endif

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a & b) | c in one instruction.  A LOP3 takes one 32-bit immediate, so
// the callers keep b and c in registers.
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The constants of int8x2_to_bf16x2, held in registers.
struct Widen {
  uint32_t low7, sign, magic;
};

// Bytes 0 and 2 of p hold two int8 values; returns them as bf16x2, exactly.
__device__ __forceinline__ uint32_t int8x2_to_bf16x2(uint32_t p, const Widen& c) {
  const uint32_t mag = and_or(p, c.low7, c.magic);  // 128 + (v & 127)
  const uint32_t off = and_or(p, c.sign, c.magic);  // 128 + (v & 128): 128 or 256
  __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&mag);
  __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&off);
  __nv_bfloat162 d = __hsub2(a, b);
  return *reinterpret_cast<uint32_t*>(&d);
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 d = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&d);
}

// D (16x8, f32) += A (16x16, bf16, row) . B (16x8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// The cluster barrier in two halves: arrive (relaxed: orders nothing) and
// wait; the kernel arrives at its start and waits before its first store
// into another CTA's shared memory, so every CTA of the cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// The barrier `bar` counts one arrival of this thread once all its
// cp.async copies issued so far have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// A plain arrival, releasing this thread's shared-memory accesses (the
// byte path of issue_q; a warp's reads of a consumed stage) to the threads
// that wait on `bar`.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

template <bool QVEC>
__device__ __forceinline__ void stage_arrive(uint64_t* bar) {
  if (QVEC) cp_async_arrive(bar);
  else mbar_arrive(bar);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Waits until phase `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Byte selector of __byte_perm(lo, hi, sel): byte b of lo into byte 0 and
// byte b of hi into byte 2.
__device__ __forceinline__ constexpr uint32_t pair_sel(int b) { return b | ((b + 4) << 8); }

// Bytes of a CTA's shared memory at chunks of kc rows: the ring, x's
// chunk (MT rows kc | 16 floats apart), its bf16 parts as B fragments (kc /
// 16 k-steps x B tiles x 32 lanes x 8 bytes), the cluster's receive buffer.
__host__ __device__ constexpr int x_pitch(int kc) { return kc | 16; }
__host__ __device__ constexpr int b_tiles(int mt, bool bf16) { return mt == 1 || bf16 ? 1 : 3; }
__host__ __device__ constexpr int smem_bytes(int mt, bool bf16, int kc) {
  return kStages * kStageBytes + mt * x_pitch(kc) * 4 + (kc / kStep) * b_tiles(mt, bf16) * 256 + mt * kBN * 4;
}

// Stage `st` of the chunk (rows st * 128 .. st * 128 + 127 of its `rows`)
// into its ring slot: copy i of the stage is the 16 bytes of row i / 8,
// chunk i % 8 (a warp's copies are 4 whole 128-byte rows); thread t makes
// copies t and t + 512.  With QVEC each copy is a cp.async, otherwise 16
// byte loads and a store.
template <bool QVEC>
__device__ __forceinline__ void issue_q(unsigned char* ring, const int8_t* __restrict__ q, int st, int k0,
                                       int rows, int n0, int N) {
#pragma unroll
  for (int u = 0; u < kCopies; ++u) {
    const int i = threadIdx.x + u * kThreads;
    const int r = i >> 3, c = i & 7;
    const int row = st * kStageRows + r;
    const int col = n0 + 16 * c;
    unsigned char* dst = ring + (st % kStages) * kStageBytes + r * kBN + ((c ^ ((r >> 1) & 6)) << 4);
    if (QVEC) {
      const bool ok = row < rows && col < N;
      cp_async16(dst, ok ? q + static_cast<size_t>(k0 + row) * N + col : q, ok);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (row < rows) {
        const int8_t* src = q + static_cast<size_t>(k0 + row) * N;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (col + j < N) w[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(src + col + j))) << (8 * (j & 3));
        }
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// MT: rows of x per CTA (1 or 8).  BF16: the bf16 arithmetic.  QVEC: q by
// 16-byte cp.async (N % 16 == 0 and q 16-byte aligned), else byte loads.
template <int MT, bool BF16, bool QVEC>
__global__ void __launch_bounds__(kThreads, 1)
    int8_matmul_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, float* __restrict__ out,
                       float* __restrict__ partial, int M, int K, int N, int kc, int slot, int xvec) {
  constexpr int kParts = BF16 ? 1 : 3;
  constexpr int kBT = b_tiles(MT, BF16);  // B tiles (n8) per k-step
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t full[kStages];   // stage st has landed: phase st / kStages of full[st % kStages]
  __shared__ uint64_t empty[kStages];  // every warp is done with stage st: the same phase of empty[st % kStages]
  __shared__ uint64_t x_full;          // x's chunk has landed
  __shared__ int last_arrival;
  unsigned char* ring = smem;
  const int xpitch = x_pitch(kc);
  float* xraw = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  uint2* xparts = reinterpret_cast<uint2*>(xraw + MT * xpitch);
  float* recv = reinterpret_cast<float*>(xparts + (kc / kStep) * kBT * 32);  // [cl][per]

  K3_MARK(0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int k0 = blockIdx.y * kc;
  const int m0 = blockIdx.z * MT;
  const int rows = max(0, min(kc, K - k0));
  const int nst = (rows + kStageRows - 1) / kStageRows;
  const int cs = warp % kSlices, kg = warp / kSlices;  // this warp's column slice and k group
  // The items of the output tile this thread sums in the end (rank r of the
  // cluster takes items [r * per, (r + 1) * per)), and their scales.
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = MT * kBN / cl;
  constexpr int kPer = (MT * kBN + kThreads - 1) / kThreads;  // items per thread, at most
  float s_out[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int n = n0 + (rank * per + tid + u * kThreads) % kBN;
    s_out[u] = !BF16 && tid + u * kThreads < per && n < N ? scale[n] : 1.f;
  }
  if (tid < kStages) {
    mbar_init(&full[tid], kThreads);
    mbar_init(&empty[tid], kWarps);
  }
  if (tid == kStages) mbar_init(&x_full, kThreads);
  cluster_arrive_relaxed();
  __syncthreads();  // the barriers are initialized (they are used inside this CTA only)

  // x's chunk (zero past M and past the chunk's rows) first, with only q's
  // first stage: sent together with more of q, it would land with the last
  // of q's bytes.  Then q's next 2 stages, while x is split into its parts;
  // the loop keeps 3 stages in flight beyond the one it consumes.  (Issued
  // all at once, the copies of a whole chunk stall the issuing threads
  // until most of it has landed, and no work overlaps the stream.)  Every
  // thread arrives on a barrier once its own copies have landed.
  if (xvec) {
    const int per_row = kc / 4;
    for (int i = tid; i < MT * per_row; i += kThreads) {
      const int m = i / per_row, c = 4 * (i - m * per_row);
      const bool ok = m0 + m < M && c < rows;
      cp_async16(xraw + m * xpitch + c, ok ? x + static_cast<size_t>(m0 + m) * K + k0 + c : x, ok);
    }
  } else {
    for (int i = tid; i < MT * kc; i += kThreads) {
      const int m = i / kc, c = i - m * kc;
      const bool ok = m0 + m < M && c < rows;
      cp_async4(xraw + m * xpitch + c, ok ? x + static_cast<size_t>(m0 + m) * K + k0 + c : x, ok);
    }
  }
  cp_async_arrive(&x_full);
  for (int st = 0; st < min(nst, kAhead); ++st) {
    if (st == 1) mbar_wait(&x_full, 0);  // q's first stage goes out with x
    issue_q<QVEC>(ring, q, st, k0, rows, n0, N);
    stage_arrive<QVEC>(&full[st]);
  }
  mbar_wait(&x_full, 0);
  K3_MARK(1);

  // x into its bf16 parts in the B fragments' order: entry (s, j, l) holds
  // lane l's two registers of B tile j at k-step s.  Lane (g, t) of a
  // k-step covers the chunk's rows 16 s + 4 t .. 16 s + 4 t + 3 (the mma's
  // k index 2t, 2t+1, 2t+8, 2t+9), column g: the row m = g of x and part j
  // (M > 1), or part g of the single row (M = 1).  Each part is bf16 of
  // what the parts before it leave, an exact f32 difference.
  for (int i = tid; i < (kc / kStep) * 32; i += kThreads) {
    const int l = i & 31, s = i >> 5;
    const float4 xv = *reinterpret_cast<const float4*>(xraw + (MT == 1 ? 0 : (l >> 2)) * xpitch + s * kStep + 4 * (l & 3));
    uint2* dst = xparts + s * kBT * 32 + l;
    float r[4] = {xv.x, xv.y, xv.z, xv.w};
    if (MT == 1) *dst = make_uint2(0u, 0u);
#pragma unroll
    for (int j = 0; j < kParts; ++j) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(r[0], r[1]), hi = __floats2bfloat162_rn(r[2], r[3]);
      const uint2 v = make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
      if (MT != 1) dst[j * 32] = v;
      else if ((l >> 2) == j) *dst = v;  // the parts are the tile's columns: lane l holds part l / 4
      if (j + 1 < kParts) {
        r[0] -= __low2float(lo);
        r[1] -= __high2float(lo);
        r[2] -= __low2float(hi);
        r[3] -= __high2float(hi);
      }
    }
  }

  // Warp (cs, kg): columns n0 + 32 cs .. + 31 as two n16 tiles, tile T's row
  // g being column 4 g + 2 T and row g + 8 column 4 g + 2 T + 1; k-steps
  // 2 kg and 2 kg + 1 of each stage.  Lane (g, t) reads the four q words at
  // rows 4 t .. 4 t + 3 of a k-step and columns 4 g .. 4 g + 3 of its slice.
  const int lane_off = (kStepsPerWarp * kStep * kg + 4 * t) * kBN + (((2 * cs + (g >> 2)) ^ (2 * t)) << 4) + ((g & 3) << 2);
  uint32_t sc[4] = {0u, 0u, 0u, 0u};  // bf16 mode: {s, s} for columns 4 g + 0..3
  if (BF16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + 32 * cs + 4 * g + j;
      const float v = n < N ? scale[n] : 0.f;
      sc[j] = pack_bf16(v, v);
    }
  }
  const Widen widen{0x007F007Fu, 0x00800080u, 0x43004300u};
  float acc[2][kBT][4];
#pragma unroll
  for (int T = 0; T < 2; ++T)
#pragma unroll
    for (int j = 0; j < kBT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[T][j][r] = 0.f;

  // One k-step: the four q words of lane (g, t), the two n16 tiles' A
  // fragments, one mma per tile and B tile.
  auto kstep = [&](const unsigned char* qs, int s) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint32_t*>(qs + i * kBN);
    uint32_t a[2][4];
#pragma unroll
    for (int T = 0; T < 2; ++T) {
      a[T][0] = int8x2_to_bf16x2(__byte_perm(w[0], w[1], pair_sel(2 * T)), widen);
      a[T][1] = int8x2_to_bf16x2(__byte_perm(w[0], w[1], pair_sel(2 * T + 1)), widen);
      a[T][2] = int8x2_to_bf16x2(__byte_perm(w[2], w[3], pair_sel(2 * T)), widen);
      a[T][3] = int8x2_to_bf16x2(__byte_perm(w[2], w[3], pair_sel(2 * T + 1)), widen);
      if (BF16) {
        a[T][0] = mul_bf16x2(a[T][0], sc[2 * T]);
        a[T][1] = mul_bf16x2(a[T][1], sc[2 * T + 1]);
        a[T][2] = mul_bf16x2(a[T][2], sc[2 * T]);
        a[T][3] = mul_bf16x2(a[T][3], sc[2 * T + 1]);
      }
    }
    const uint2* b = xparts + s * kBT * 32 + lane;
#pragma unroll
    for (int j = 0; j < kBT; ++j) {
      const uint2 bj = b[j * 32];
      mma_bf16(acc[0][j], a[0], bj.x, bj.y);
      mma_bf16(acc[1][j], a[1], bj.x, bj.y);
    }
  };

  __syncthreads();  // the x parts are written
  K3_MARK(2);

  for (int st = 0; st < nst; ++st) {
    const int next = st + kAhead;
    if (next < nst) {
      // The slot of stage next - 8 must be free: every warp has consumed it.
      if (next >= kStages) mbar_wait(&empty[next % kStages], ((next / kStages) - 1) & 1);
      issue_q<QVEC>(ring, q, next, k0, rows, n0, N);
      stage_arrive<QVEC>(&full[next % kStages]);
    }
    mbar_wait(&full[st % kStages], (st / kStages) & 1);  // every thread's copies of stage st
    const unsigned char* qs = ring + (st % kStages) * kStageBytes + lane_off;
    const int s = (st * kKGroups + kg) * kStepsPerWarp;  // this warp's first k-step of the stage
    if ((s + kStepsPerWarp) * kStep <= rows) {  // both k-steps, branch-free
#pragma unroll
      for (int u = 0; u < kStepsPerWarp; ++u) kstep(qs + u * kStep * kBN, s + u);
    } else {  // the chunk's last rows
#pragma unroll
      for (int u = 0; u < kStepsPerWarp; ++u) {
        if ((s + u) * kStep < rows) kstep(qs + u * kStep * kBN, s + u);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st % kStages]);  // this warp is done with stage st
  }
  __syncthreads();  // every copy has landed and the ring is free
  K3_MARK(3);

  // Each warp's partial sums, parts added (lo + mid) + hi, into red[kg][m][n].
  float* red = reinterpret_cast<float*>(ring);
  float* dst = red + kg * MT * kRedPitch + 32 * cs + 4 * g;
  if (MT == 1) {
    float v[2][2];
#pragma unroll
    for (int T = 0; T < 2; ++T) {
      // Columns of D: 0 hi, 1 mid (lane t = 0), 2 lo (lane t = 1).
      const float lo0 = __shfl_down_sync(0xffffffffu, acc[T][0][0], 1);
      const float lo2 = __shfl_down_sync(0xffffffffu, acc[T][0][2], 1);
      v[T][0] = BF16 ? acc[T][0][0] : (lo0 + acc[T][0][1]) + acc[T][0][0];
      v[T][1] = BF16 ? acc[T][0][2] : (lo2 + acc[T][0][3]) + acc[T][0][2];
    }
    if (t == 0) *reinterpret_cast<float4*>(dst) = make_float4(v[0][0], v[0][1], v[1][0], v[1][1]);
  } else {
    float v[2][4];
#pragma unroll
    for (int T = 0; T < 2; ++T)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[T][r] = kBT == 3 ? (acc[T][2 % kBT][r] + acc[T][1 % kBT][r]) + acc[T][0][r] : acc[T][0][r];
    // D's row g is column 4 g + 2 T, row g + 8 column 4 g + 2 T + 1; its
    // columns 2 t and 2 t + 1 are rows m of x.
    *reinterpret_cast<float4*>(dst + (2 * t) * kRedPitch) = make_float4(v[0][0], v[0][2], v[1][0], v[1][2]);
    *reinterpret_cast<float4*>(dst + (2 * t + 1) * kRedPitch) = make_float4(v[0][1], v[0][3], v[1][1], v[1][3]);
  }
  __syncthreads();
  // This CTA's partial tile, item i = m * 128 + n summed over the 4 warps
  // along K, is pushed into the shared memory of rank i / per of the
  // cluster, at row `rank` of its receive buffer; then one cluster barrier,
  // and each rank adds its rows in rank order.
  cluster_wait();  // every CTA of the cluster has started
  for (int i = tid; i < MT * kBN; i += kThreads) {
    const int m = i / kBN, n = i % kBN;
    float v = red[m * kRedPitch + n];
#pragma unroll
    for (int w = 1; w < kKGroups; ++w) v += red[(w * MT + m) * kRedPitch + n];
    cluster.map_shared_rank(recv, i / per)[rank * per + i % per] = v;
  }
  cluster.sync();
  K3_MARK(4);
  float v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    v[u] = 0.f;
    if (tid + u * kThreads < per) {
      v[u] = recv[tid + u * kThreads];
      for (int r = 1; r < cl; ++r) v[u] += recv[r * per + tid + u * kThreads];
    }
  }

  const int groups = gridDim.y / cl;
  const int tiles = gridDim.x * gridDim.z;
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (groups > 1) {
    // This rank's share of the cluster's sum into the workspace; the last
    // cluster to arrive adds the clusters' shares up in cluster order.
    float* mine = partial + (static_cast<size_t>(blockIdx.y / cl) * tiles + tile) * (MT * kBN);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (tid + u * kThreads < per) mine[rank * per + tid + u * kThreads] = v[u];
    }
    __syncthreads();
    if (tid == 0) {  // the CTA's stores, then its arrival (a fence by one thread after the barrier covers them)
      unsigned int* counter = g_arrivals + slot * kSlotCounters + tile * cl + rank;
      __threadfence();
      const bool last = atomicAdd(counter, 1u) == static_cast<unsigned int>(groups - 1);
      if (last) *counter = 0u;  // every arrival of this call is counted
      __threadfence();  // the others' stores, before this CTA's loads below
      last_arrival = last;
    }
    __syncthreads();
    K3_MARK(5);
    if (!last_arrival) return;
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (tid + u * kThreads < per) {
        const float* src = partial + static_cast<size_t>(tile) * (MT * kBN) + rank * per + tid + u * kThreads;
        const size_t stride = static_cast<size_t>(tiles) * (MT * kBN);
        float s = 0.f;
        for (int g0 = 0; g0 < groups; g0 += 16) {  // 16 loads in flight, summed in group order
          float gv[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) gv[e] = g0 + e < groups ? __ldcg(src + (g0 + e) * stride) : 0.f;
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            if (g0 + e < groups) s = g0 + e == 0 ? gv[e] : s + gv[e];
          }
        }
        v[u] = s;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (tid + u * kThreads >= per) continue;
    const int i = rank * per + tid + u * kThreads;
    const int m = m0 + i / kBN, n = n0 + i % kBN;
    if (m < M && n < N) out[static_cast<size_t>(m) * N + n] = BF16 ? v[u] : v[u] * s_out[u];
  }
  K3_MARK(6);
}

// Lets `kernel` ask for its largest dynamic shared memory on the current
// device, once per kernel and device (a repeat from a racing thread is
// harmless).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ULL << dev : 0ULL;
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

cudaLaunchConfig_t cluster_config(dim3 grid, int cl, int smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = cl;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int MT, bool BF16, bool QVEC>
cudaError_t launch(dim3 grid, int cl, cudaStream_t stream, const float* x, const int8_t* q, const float* scale,
                   float* out, float* partial, int M, int K, int N, int kc, int slot, int xvec) {
  auto kernel = int8_matmul_kernel<MT, BF16, QVEC>;
  static unsigned long long opted = 0ULL;
  cudaError_t err = opt_in_smem(kernel, smem_bytes(MT, BF16, kMaxKC), opted);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(grid, cl, smem_bytes(MT, BF16, kc), stream, &attr);
  return cudaLaunchKernelEx(&cfg, kernel, x, q, scale, out, partial, M, K, N, kc, slot, xvec);
}

template <int MT, bool BF16>
cudaError_t launch_q(bool qvec, dim3 grid, int cl, cudaStream_t stream, const float* x, const int8_t* q,
                   const float* scale, float* out, float* partial, int M, int K, int N, int kc, int slot,
                   int xvec) {
  return qvec ? launch<MT, BF16, true>(grid, cl, stream, x, q, scale, out, partial, M, K, N, kc, slot, xvec)
              : launch<MT, BF16, false>(grid, cl, stream, x, q, scale, out, partial, M, K, N, kc, slot, xvec);
}

}  // namespace

extern "C" {

// How many clusters of `cl` CTAs (at the largest shared memory) the current
// device holds at once, or minus a cudaError_t.
int rsfd_int8_matmul_max_clusters(int cl) {
  if (cl < 1 || cl > kMaxCluster) return -static_cast<int>(cudaErrorInvalidValue);
  auto kernel = int8_matmul_kernel<8, false, true>;
  static unsigned long long opted = 0ULL;
  const int smem = smem_bytes(8, false, kMaxKC);
  cudaError_t err = opt_in_smem(kernel, smem, opted);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(dim3(1, cl, 1), cl, smem, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// x (M, K) f32, q (K, N) int8 and scale (N,) f32, all contiguous on one
// device; out (M, N) f32.  K is cut into `chunks` chunks of `kc` rows (kc a
// multiple of 16, at most 1024; chunks * kc >= K, trailing chunks may be
// empty), `cluster` (1, 2 or 4) of them to a thread-block cluster.  With
// more than one cluster per column tile, `partial` holds (chunks / cluster)
// x tiles x (8 or 1) x 128 floats and counter slot `slot` (0 .. 31, one per
// stream) must not be used by another call in flight.  Launches one kernel
// on `stream` and returns cudaGetLastError().
int rsfd_int8_matmul(const float* x, const int8_t* q, const float* scale, float* out, float* partial, int M,
                     int K, int N, int kc, int chunks, int cluster, int slot, int bf16, void* stream_ptr) {
  if (M <= 0 || K <= 0 || N <= 0 || kc < kStep || kc > kMaxKC || kc % kStep || chunks < 1 || chunks > 65535 ||
      static_cast<long long>(chunks) * kc < K || (cluster != 1 && cluster != 2 && cluster != 4) ||
      chunks % cluster || slot < 0 || slot >= kSlots) {
    return cudaErrorInvalidValue;
  }
  const int mt = M == 1 ? 1 : 8;
  const long long n_tiles = (N + kBN - 1) / kBN, m_tiles = (M + mt - 1) / mt;
  if (m_tiles > 65535 || n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (chunks > cluster && n_tiles * m_tiles * cluster > kSlotCounters) return cudaErrorInvalidValue;
  const bool qvec = N % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int xvec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(n_tiles), chunks, static_cast<unsigned>(m_tiles));
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (mt == 1) {
    err = bf16 ? launch_q<1, true>(qvec, grid, cluster, stream, x, q, scale, out, partial, M, K, N, kc, slot, xvec)
               : launch_q<1, false>(qvec, grid, cluster, stream, x, q, scale, out, partial, M, K, N, kc, slot, xvec);
  } else {
    err = bf16 ? launch_q<8, true>(qvec, grid, cluster, stream, x, q, scale, out, partial, M, K, N, kc, slot, xvec)
               : launch_q<8, false>(qvec, grid, cluster, stream, x, q, scale, out, partial, M, K, N, kc, slot, xvec);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

#ifdef RSFD_K3_TIMELINE
// Copies the stamps of the last launch's first `ctas` CTAs to `dst` (host).
int rsfd_int8_matmul_timeline(void* dst, int ctas) {
  return cudaMemcpyFromSymbol(dst, g_timeline, sizeof(unsigned long long) * kMarks * ctas);
}
#endif

}  // extern "C"
