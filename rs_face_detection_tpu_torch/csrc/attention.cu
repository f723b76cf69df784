// Flash-attention forward for Hopper (sm_90a): K4.
//
// Replaces the Pallas TPU flash attention that rs_face_detection_tpu/
// models/vit.py::_flash_attention_fn calls (jax.experimental.pallas.ops.tpu.
// flash_attention): dense, non-causal softmax(Q K^T / sqrt(D)) V over
// (B, N, H, D) q, k and v.  The TPU version transposes to (B, H, N, D), pads
// N to a multiple of 128 and masks the pad keys with SegmentIds; none of that
// is carried over.  Here q, k and v are read in place through their strides
// (the ViT passes the three slices of its packed (B, N, 3, H, D) qkv
// projection), keys >= N are masked to -inf by bounds and query rows >= N
// are never stored.  The output is a contiguous (B, N, H, D) tensor.
//
// What bounds it on this card.  At the ViT-L/14 shape (8, 257, 16, 64) in
// bf16, reading q, k and v and writing o moves 4 x 4.21 MB = 16.8 MB, 5.0 us
// at 3.35 TB/s; the products are 4 B H N^2 D = 2.16 GFLOP, 2.2 us at
// 989 TFLOP/s.  So it is bound by memory, at about 5 us a launch.  The
// (B, H, N, N) scores and probabilities, 33.8 MB in f32 at that shape, never
// reach device memory.
//
// The bf16 path (flash_fwd_bf16), redesigned for Hopper:
//   * K and V are read once per CTA.  A CTA serves one (batch, head) and a
//     contiguous range of its 16-row query fragments, and keeps the head's
//     whole K and V in shared memory while its warps walk them.  The
//     wrapper's launch_plan (kernels/attention.py) picks the split of a
//     head's fragments over CTAs from B * H: about two CTAs per SM (two fit
//     by shared memory), never fewer than two fragments per CTA.  The
//     tower's b8 (128 heads) runs 2 CTAs of 5 warps per head; a verify's b1
//     (16 heads) 8 CTAs of 3 warps.  Each warp owns one 16-row fragment per
//     round; the spare row of N = 257 = 16 * 16 + 1 costs one 16-row
//     fragment, not a 64-row tile.
//   * K/V arrive by cp.async (16 bytes a thread, zero-filled past N) into a
//     ring of 64-key stages in shared memory, one commit group per stage.  If
//     the head fits (N <= 8 x 64 keys: 92,160 B at N = 257, D = 64) every
//     stage stays resident: round 0 waits for stage j only, so the copies of
//     stages j+1.. overlap stage j's products, and later rounds read shared
//     memory alone.  A longer head streams through 8 stages, refilled as
//     each is released (one __syncthreads per stage).
//   * V stays row-major.  QK^T reads K with ldmatrix, PV reads V with
//     ldmatrix.trans; rows are padded by 8 elements (a 144-byte pitch at D =
//     64), so the eight row addresses of each 8x8 matrix fall in distinct
//     bank groups: no scalar transpose and no bank conflicts.
//   * A full 64-key stage runs branch-free, so the compiler interleaves its
//     eight independent key blocks; only the last, partial stage masks keys
//     at 8-key granularity (a QK^T block of 8 keys past N is skipped, a PV
//     step of 16 keys past N is skipped).  At N = 257 the products cover 272
//     query rows x 264 keys (QK^T) or 272 keys (PV): 9.4% padding, against
//     35.5% for the PR 3 kernel's 64 x 64 tiles.
//   * Products on mma.sync.m16n8k16 (bf16 in, f32 accumulate), not wgmma:
//     wgmma's M is 64 rows per warpgroup, so the spare query row would cost
//     a 64-row product again, and the products (2.2 us at the wgmma peak)
//     are not what bounds the kernel; mma.sync lets each warp own 16 rows.
//     P stays in registers: QK^T's C fragments are PV's A fragments.
//   * Online softmax in f32 per 64-key stage: scores scaled into the log2
//     domain by one fmaf each, exponentials on ex2.approx, running max and
//     sum per row; P is rounded to bf16 for PV; the division by the row sum
//     comes at the end.
// The f32 path (flash_fwd_f32) is the PR 3 kernel as it was: one CTA of 4
// warps per (64-query tile, head, batch), scalar FMAs, two threads per query
// row; its shared memory (49,664 B) needs the opt-in above 48 KB.
// The file builds with -fmad=false; both paths use explicit fmaf where they
// want a fused product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // f32 path
constexpr int kBM = 64;        // f32 path: query rows per CTA
constexpr int kBN = 64;        // f32 path: keys per K/V tile

constexpr int kStageKeys = 64;  // bf16 path: keys per cp.async stage
constexpr int kMaxStages = 8;   // bf16 path: stages in the ring at most
constexpr int kMaxWarps = 8;    // bf16 path: warps per CTA at most

struct Strides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh;  // in elements; D has stride 1
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (16x8, f32) += A (16x16, bf16, row) . B (16x8, bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's commit groups are in flight
// (wait_group takes an immediate; more than 7 waits for 7, which is safe).
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of the bf16 path: K and V rings, `stages` x 64 rows each.
template <int D>
constexpr int bf16_stage_bytes() {
  return 2 * kStageKeys * (D + 8) * (int)sizeof(__nv_bfloat16);
}

// One 16-row query fragment as mma A fragments (rows >= N are 0).
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&qa)[D / 16][4], const __nv_bfloat16* qbase,
                                       long long qn, int row0, int N, int g, int t) {
  const int n0 = row0 + g, n1 = n0 + 8;
  const __nv_bfloat16* p0 = qbase + (long long)min(n0, N - 1) * qn + 2 * t;
  const __nv_bfloat16* p1 = qbase + (long long)min(n1, N - 1) * qn + 2 * t;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = n0 < N ? *reinterpret_cast<const uint32_t*>(p0 + kk * 16) : 0u;
    qa[kk][1] = n1 < N ? *reinterpret_cast<const uint32_t*>(p1 + kk * 16) : 0u;
    qa[kk][2] = n0 < N ? *reinterpret_cast<const uint32_t*>(p0 + kk * 16 + 8) : 0u;
    qa[kk][3] = n1 < N ? *reinterpret_cast<const uint32_t*>(p1 + kk * 16 + 8) : 0u;
  }
}

// One 64-key stage for a warp's 16-row query fragment: S = Q K^T, the
// online-softmax update, O += P V.  kFull: all 64 keys are < N, so every
// product runs unconditionally and the compiler interleaves the eight
// independent key blocks; the last, partial stage of a head takes the
// guarded path (kFull = false), which skips key blocks past N and masks
// keys at 8-key granularity.  K and V rows past N are zero in shared memory.
template <int D, bool kFull>
__device__ __forceinline__ void bf16_stage(const uint32_t (&qa)[D / 16][4], float (&acc)[D / 8][4],
                                           float (&m)[2], float (&l)[2], const __nv_bfloat16* Kt,
                                           const __nv_bfloat16* Vt, int valid, float scale_log2,
                                           int lane, int t) {
  constexpr int kLd = D + 8;
  // S for 16 rows x 64 keys: 8 C fragments of 8 keys each.
  float s[kStageKeys / 8][4];
#pragma unroll
  for (int j = 0; j < kStageKeys / 8; ++j) {
    if (kFull || 8 * j < valid) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = Kt + (8 * j + (lane & 7)) * kLd + (lane >> 3) * 8;
#pragma unroll
      for (int kk2 = 0; kk2 < D / 32; ++kk2) {
        uint32_t kb[4];
        ldsm_x4(kb, krow + kk2 * 32);
        mma_bf16(s[j], qa[2 * kk2], kb[0], kb[1]);
        mma_bf16(s[j], qa[2 * kk2 + 1], kb[2], kb[3]);
      }
      if (!kFull) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (8 * j + 2 * t + e >= valid) s[j][e] = s[j][2 + e] = -CUDART_INF_F;
        }
      }
    } else {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = -CUDART_INF_F;
    }
  }

  // Rows g and g + 8: new running max (log2 domain), the rescale of the old
  // sum and accumulator, P = exp2(s * scale - m).
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < kStageKeys / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
  }
  // Every stage holds key k0 < N, so the new maxima are finite; the first
  // stage's rescale factor is exp2(-inf) = 0.
  const float mn0 = fmaxf(m[0], mx0 * scale_log2), mn1 = fmaxf(m[1], mx1 * scale_log2);
  const float alpha0 = ex2(m[0] - mn0), alpha1 = ex2(m[1] - mn1);
  m[0] = mn0;
  m[1] = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < kStageKeys / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[j][e] = ex2(fmaf(s[j][e], scale_log2, -mn0));
      s[j][2 + e] = ex2(fmaf(s[j][2 + e], scale_log2, -mn1));
      rs0 += s[j][e];
      rs1 += s[j][2 + e];
    }
  }
  l[0] = l[0] * alpha0 + rs0;
  l[1] = l[1] * alpha1 + rs1;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    acc[nt][0] *= alpha0;
    acc[nt][1] *= alpha0;
    acc[nt][2] *= alpha1;
    acc[nt][3] *= alpha1;
  }

  // O += P V, 16 keys a step: P's C fragments of keys 16kc..16kc+15 are
  // PV's A fragment; V's B fragments come from ldmatrix.trans of the
  // row-major stage.
#pragma unroll
  for (int kc = 0; kc < kStageKeys / 16; ++kc) {
    if (kFull || 16 * kc < valid) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
      const __nv_bfloat16* vrow =
          Vt + (16 * kc + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd + (lane >> 4) * 8;
#pragma unroll
      for (int ntp = 0; ntp < D / 16; ++ntp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vrow + ntp * 16);
        mma_bf16(acc[2 * ntp], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * ntp + 1], pa, vb[2], vb[3]);
      }
    }
  }
}

// grid: B * H * splits CTAs; block: warps x 32 threads; dynamic shared
// memory: stages x bf16_stage_bytes<D>().
template <int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int N,
                   int H, Strides st, float scale_log2, int splits, int stages) {
  constexpr int kLd = D + 8;  // row pitch of the K and V stages, in elements
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kStage = kStageKeys * kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + stages * kStage;

  const int split = blockIdx.x % splits, bh = blockIdx.x / splits;
  const int b = bh / H, h = bh % H;
  const int warps = blockDim.x >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  const __nv_bfloat16* qbase = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kbase = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vbase = v + b * st.vb + h * st.vh;

  // This CTA's 16-row query fragments [f0, f1), an even split of the head's
  // fragments over its `splits` CTAs; warp w takes f0 + r * warps + w in
  // round r.  launch_plan picks splits and warps so that the rounds cover
  // the largest share.
  const int frags = (N + 15) / 16;
  const int f0 = (int)((long long)split * frags / splits);
  const int f1 = (int)((long long)(split + 1) * frags / splits);
  const int rounds = (f1 - f0 + warps - 1) / warps;
  const int tiles = (N + kStageKeys - 1) / kStageKeys;
  const bool resident = tiles <= stages;
  const int prologue = min(tiles, stages);

  // Stage `tile` of this head's K and V into ring slot `slot`.
  auto issue = [&](int tile, int slot) {
    __nv_bfloat16* kd = Ks + slot * kStage;
    __nv_bfloat16* vd = Vs + slot * kStage;
    for (int i = tid; i < kStageKeys * kChunks; i += blockDim.x) {
      const int r = i / kChunks, c = i % kChunks, n = tile * kStageKeys + r;
      const bool in = n < N;
      const long long nn = in ? n : 0;
      cp_async16(kd + r * kLd + c * 8, kbase + nn * st.kn + c * 8, in);
      cp_async16(vd + r * kLd + c * 8, vbase + nn * st.vn + c * 8, in);
    }
  };
  for (int s = 0; s < prologue; ++s) {
    issue(s, s);
    cp_async_commit();
  }

  for (int r = 0; r < rounds; ++r) {
    const int frag = f0 + r * warps + warp;
    const bool active = frag < f1;
    uint32_t qa[D / 16][4];
    load_q<D>(qa, qbase, st.qn, frag * 16, N, g, t);

    // Rows g and g + 8 of the fragment: running max (log2 domain), this
    // thread's share of the running sum, the output accumulator over D.
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f}, acc[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

    for (int tile = 0; tile < tiles; ++tile) {
      const int gi = resident ? tile : r * tiles + tile;  // commit group of this stage
      const int slot = gi % stages;
      if (!resident || r == 0) {
        const int committed = resident ? prologue : prologue + gi;
        cp_async_wait(committed - gi - 1);
        __syncthreads();  // every thread's copies of the stage have landed
      }
      if (active) {
        const int valid = min(kStageKeys, N - tile * kStageKeys);
        const __nv_bfloat16* Kt = Ks + slot * kStage;
        const __nv_bfloat16* Vt = Vs + slot * kStage;
        if (valid == kStageKeys) {
          bf16_stage<D, true>(qa, acc, m, l, Kt, Vt, valid, scale_log2, lane, t);
        } else {
          bf16_stage<D, false>(qa, acc, m, l, Kt, Vt, valid, scale_log2, lane, t);
        }
      }
      if (!resident) {
        __syncthreads();  // every warp is done with this slot: refill it
        const int next = gi + stages;
        if (next < rounds * tiles) issue(next % tiles, slot);
        cp_async_commit();  // possibly empty: one group per consumed stage
      }
    }

    if (active) {
      float l0 = l[0], l1 = l[1];
#pragma unroll
      for (int w = 1; w < 4; w <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, w);
        l1 += __shfl_xor_sync(0xffffffffu, l1, w);
      }
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      const int n0 = frag * 16 + g, n1 = n0 + 8;
      __nv_bfloat16* o0 = o + ((long long)b * N + n0) * H * D + (long long)h * D + 2 * t;
      __nv_bfloat16* o1 = o0 + 8LL * H * D;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        if (n0 < N)
          *reinterpret_cast<uint32_t*>(o0 + nt * 8) = pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
        if (n1 < N)
          *reinterpret_cast<uint32_t*>(o1 + nt * 8) = pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
      }
    }
  }
  cp_async_wait(0);  // no copy outlives the CTA
}

// f32 shared memory: K tile (pitch D + 1), V tile (pitch D), P tile (pitch
// kBN + 1), in floats.
template <int D>
constexpr int f32_smem_bytes() {
  return (kBN * (D + 1) + kBN * D + kBM * (kBN + 1)) * (int)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int N, int H, Strides st,
                  float scale_log2) {
  constexpr int kLdK = D + 1, kLdP = kBN + 1, kHalf = D / 2;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kBN * kLdK;
  float* Ps = Vs + kBN * D;

  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, r = tid >> 1, half = tid & 1, n = q0 + r;
  const float* kbase = k + b * st.kb + h * st.kh;
  const float* vbase = v + b * st.vb + h * st.vh;

  float qr[D];
  const float* qrow = q + b * st.qb + h * st.qh + (long long)min(n, N - 1) * st.qn;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = n < N ? qrow[d] : 0.f;

  float m = -CUDART_INF_F, l = 0.f;
  float acc[kHalf];
#pragma unroll
  for (int e = 0; e < kHalf; ++e) acc[e] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBN) {
    __syncthreads();
    for (int i = tid; i < kBN * D; i += kThreads) {
      const int kr = i / D, d = i % D, kn = k0 + kr;
      Ks[kr * kLdK + d] = kn < N ? kbase[kn * st.kn + d] : 0.f;
      Vs[kr * D + d] = kn < N ? vbase[kn * st.vn + d] : 0.f;
    }
    __syncthreads();

    // This thread scores keys 2i + half of the tile.
    float sc[kBN / 2];
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int j = 2 * i + half;
      const float* krow = &Ks[j * kLdK];
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) a = fmaf(qr[d], krow[d], a);
      sc[i] = k0 + j < N ? a * scale_log2 : -CUDART_INF_F;
      mx = fmaxf(mx, sc[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mn = fmaxf(m, mx);
    const float alpha = exp2f(m - mn);
    m = mn;
    float rs = 0.f;
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const float p = exp2f(sc[i] - m);
      rs += p;
      Ps[r * kLdP + 2 * i + half] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l = l * alpha + rs;
#pragma unroll
    for (int e = 0; e < kHalf; ++e) acc[e] *= alpha;
    __syncwarp();  // the two threads of a row share a warp and its P row

    const float* prow = &Ps[r * kLdP];
    for (int j = 0; j < kBN; ++j) {
      const float p = prow[j];
      const float* vrow = &Vs[j * D + half * kHalf];
#pragma unroll
      for (int e = 0; e < kHalf; ++e) acc[e] = fmaf(p, vrow[e], acc[e]);
    }
  }

  if (n < N) {
    float* orow = o + (((long long)b * N + n) * H + h) * D + half * kHalf;
#pragma unroll
    for (int e = 0; e < kHalf; ++e) orow[e] = acc[e] / l;
  }
}

// Lets `kernel` ask for up to `bytes` of dynamic shared memory on the
// current device.  The opt-in is a driver call, so it is made once per kernel
// and device (a repeat from a racing thread is harmless), not on every launch.
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

}  // namespace

extern "C" {

// q, k, v: (B, N, H, D) with element strides for B, N and H and unit stride
// for D; o: contiguous (B, N, H, D).  dtype 0 = float32, 1 = bfloat16.  For
// bf16, splits (CTAs per head), warps (per CTA) and stages (64-key K/V
// stages in shared memory) come from kernels/attention.py::launch_plan; the
// f32 path ignores them.  The wrapper checks shapes, types and 16-byte
// alignment of every row.  Returns the cudaError_t of the launch.
int rsfd_flash_attention(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
                         int D, int dtype, long long qb, long long qn, long long qh, long long kb,
                         long long kn, long long kh, long long vb, long long vn, long long vh,
                         int splits, int warps, int stages, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const Strides st{qb, qn, qh, kb, kn, kh, vb, vn, vh};
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && (D == 64 || D == 32)) {
    const int frags = (N + 15) / 16;
    const int tiles = (N + kStageKeys - 1) / kStageKeys;
    if (splits < 1 || splits > frags || warps < 1 || warps > kMaxWarps || stages < 1 ||
        stages > kMaxStages || stages > tiles || (long long)B * H * splits > 0x7fffffffLL) {
      return (int)cudaErrorInvalidValue;
    }
    static unsigned long long opted[2];  // per D: devices whose opt-in is made
    auto kernel = D == 64 ? flash_fwd_bf16<64> : flash_fwd_bf16<32>;
    const int stage = D == 64 ? bf16_stage_bytes<64>() : bf16_stage_bytes<32>();
    const int smem = stages * stage;
    if (smem > 48 * 1024) {
      const cudaError_t err = opt_in_smem(kernel, kMaxStages * stage, opted[D == 64]);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<B * H * splits, warps * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), N, H, st,
        scale_log2, splits, stages);
  } else if (dtype == 0 && (D == 64 || D == 32)) {
    const dim3 grid((N + kBM - 1) / kBM, H, B);
    const int smem = D == 64 ? f32_smem_bytes<64>() : f32_smem_bytes<32>();
    auto kernel = D == 64 ? flash_fwd_f32<64> : flash_fwd_f32<32>;
    static unsigned long long opted[2];
    if (smem > 48 * 1024) {
      const cudaError_t err = opt_in_smem(kernel, smem, opted[D == 64]);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, kThreads, smem, s>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                        static_cast<const float*>(v), static_cast<float*>(o), N,
                                        H, st, scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
