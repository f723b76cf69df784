// Flash-attention forward for Hopper (sm_90a): K4.
//
// Replaces the Pallas TPU flash attention that rs_face_detection_tpu/
// models/vit.py::_flash_attention_fn calls (jax.experimental.pallas.ops.tpu.
// flash_attention): dense, non-causal softmax(Q K^T / sqrt(D)) V over
// (B, N, H, D) q, k and v.  The TPU version transposes to (B, H, N, D), pads
// N to a multiple of 128 and masks the pad keys with SegmentIds; none of that
// is carried over.  Here q, k and v are read in place through their strides
// (the ViT passes the three slices of its packed (B, N, 3, H, D) qkv
// projection), the last key tile masks keys >= N to -inf by bounds, and query
// rows >= N are never stored.  The output is a contiguous (B, N, H, D) tensor.
//
// What bounds it on this card.  At the ViT-L/14 shape (8, 257, 16, 64) in
// bf16, reading q, k and v and writing o moves 4 x 4.21 MB = 16.8 MB, 5.0 us
// at 3.35 TB/s; the products are 4 B H N^2 D = 2.16 GFLOP, 2.2 us at
// 989 TFLOP/s.  So it is bound by memory, at about 5 us a launch.  The point
// of the kernel is that the (B, H, N, N) scores and probabilities, 33.8 MB in
// f32 at that shape, never reach device memory.
//
// What the design does (simple and right first):
//   * one CTA of 4 warps per (64-query tile, head, batch); each warp owns 16
//     query rows.  The 64 x D query tile is staged in shared memory once and
//     held in registers as mma A fragments;
//   * K and V tiles of 64 keys are staged in shared memory (V transposed, so
//     that the PV product reads its B fragments as 32-bit words); rows are
//     padded by 8 elements so the fragment reads hit 32 distinct banks;
//   * bf16: QK^T and PV with mma.sync.aligned.m16n8k16 (bf16 in, f32
//     accumulate).  The scores are scaled by 1/sqrt(D) in f32; the online
//     softmax keeps a running max and sum per row in f32 and rescales the
//     f32 accumulator in registers; P is rounded to bf16 in registers (the
//     C fragment of QK^T is the A fragment of PV) before PV; the division by
//     the row sum comes at the end;
//   * f32: the same tiles, with scalar FMAs: two threads per query row, each
//     scoring every other key of the tile and accumulating half of D.  Its
//     shared memory (49,664 B) needs the opt-in above 48 KB.
// The file builds with -fmad=false; the f32 path's dot products use explicit
// fmaf, the softmax's scaling and exponent arguments round on their own.
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 64;  // query rows per CTA
constexpr int kBN = 64;  // keys per K/V tile

struct Strides {
  long long qb, qn, qh, kb, kn, kh, vb, vn, vh;  // in elements; D has stride 1
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

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

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int N,
                   int H, Strides st, float scale_log2) {
  constexpr int kLdQ = D + 8;    // row pitch of Qs and Ks, in elements
  constexpr int kLdV = kBN + 8;  // row pitch of Vt (rows are d, columns keys)
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 Qs[kBM * kLdQ];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBN * kLdQ];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * kLdV];

  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  const __nv_bfloat16* qbase = q + b * st.qb + h * st.qh;
  const __nv_bfloat16* kbase = k + b * st.kb + h * st.kh;
  const __nv_bfloat16* vbase = v + b * st.vb + h * st.vh;

  for (int i = tid; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks, n = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n < N) val = *reinterpret_cast<const uint4*>(qbase + n * st.qn + c * 8);
    *reinterpret_cast<uint4*>(&Qs[r * kLdQ + c * 8]) = val;
  }
  __syncthreads();

  // This warp's 16 query rows as A fragments, one per 16-wide slice of D.
  const int r0 = warp * 16 + g;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = ld32(&Qs[r0 * kLdQ + kk * 16 + 2 * t]);
    qa[kk][1] = ld32(&Qs[(r0 + 8) * kLdQ + kk * 16 + 2 * t]);
    qa[kk][2] = ld32(&Qs[r0 * kLdQ + kk * 16 + 2 * t + 8]);
    qa[kk][3] = ld32(&Qs[(r0 + 8) * kLdQ + kk * 16 + 2 * t + 8]);
  }

  // Rows r0 and r0 + 8: running max (log2 domain), this thread's share of
  // the running sum, and the output accumulator (C fragments over D).
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBN) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBN * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks, n = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (n < N) {
        kv = *reinterpret_cast<const uint4*>(kbase + n * st.kn + c * 8);
        vv = *reinterpret_cast<const uint4*>(vbase + n * st.vn + c * 8);
      }
      *reinterpret_cast<uint4*>(&Ks[r * kLdQ + c * 8]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c * 8 + e) * kLdV + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys: 8 C fragments of 8 keys each.
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = &Ks[(j * 8 + g) * kLdQ + 2 * t];
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) mma_bf16(s[j], qa[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    // Scale in f32, mask keys >= N, row max over the 4 threads of a row.
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = k0 + j * 8 + 2 * t + e < N;
        s[j][e] = in ? s[j][e] * scale_log2 : -CUDART_INF_F;
        s[j][2 + e] = in ? s[j][2 + e] * scale_log2 : -CUDART_INF_F;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    // Every tile holds key k0 < N, so the new maxima are finite; the first
    // tile's rescale factor is exp2(-inf) = 0.
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = exp2f(s[j][e] - m0);
        s[j][2 + e] = exp2f(s[j][2 + e] - m1);
        rs0 += s[j][e];
        rs1 += s[j][2 + e];
      }
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] *= alpha0;
      acc[nt][1] *= alpha0;
      acc[nt][2] *= alpha1;
      acc[nt][3] *= alpha1;
    }

    // O += P V: P's C fragments of keys 16kc..16kc+15 are PV's A fragment.
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        const __nv_bfloat16* vrow = &Vt[(nt * 8 + g) * kLdV + kc * 16 + 2 * t];
        mma_bf16(acc[nt], pa, ld32(vrow), ld32(vrow + 8));
      }
    }
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int n0 = q0 + r0, n1 = n0 + 8;
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

}  // namespace

extern "C" {

// q, k, v: (B, N, H, D) with element strides for B, N and H and unit stride
// for D; o: contiguous (B, N, H, D).  dtype 0 = float32, 1 = bfloat16.  The
// wrapper (kernels/attention.py) checks shapes, types and 16-byte alignment
// of every row.  Returns the cudaError_t of the launch.
int rsfd_flash_attention(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
                         int D, int dtype, long long qb, long long qn, long long qh, long long kb,
                         long long kn, long long kh, long long vb, long long vn, long long vh,
                         void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const Strides st{qb, qn, qh, kb, kn, kh, vb, vn, vh};
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const dim3 grid((N + kBM - 1) / kBM, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  const auto* qb16 = static_cast<const __nv_bfloat16*>(q);
  const auto* kb16 = static_cast<const __nv_bfloat16*>(k);
  const auto* vb16 = static_cast<const __nv_bfloat16*>(v);
  auto* ob16 = static_cast<__nv_bfloat16*>(o);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  if (dtype == 1 && D == 64) {
    flash_fwd_bf16<64><<<grid, kThreads, 0, s>>>(qb16, kb16, vb16, ob16, N, H, st, scale_log2);
  } else if (dtype == 1 && D == 32) {
    flash_fwd_bf16<32><<<grid, kThreads, 0, s>>>(qb16, kb16, vb16, ob16, N, H, st, scale_log2);
  } else if (dtype == 0 && (D == 64 || D == 32)) {
    const int smem = D == 64 ? f32_smem_bytes<64>() : f32_smem_bytes<32>();
    auto kernel = D == 64 ? flash_fwd_f32<64> : flash_fwd_f32<32>;
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, kThreads, smem, s>>>(qf, kf, vf, of, N, H, st, scale_log2);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
