// Int8 dequant-matmul for Hopper (sm_90a): K3.
//
// Replaces rs_face_detection_tpu/ops/quantize.py:210 int8_matmul (body
// _int8_matmul_kernel :201-206): out (M, N) f32 = x (M, K) @ (q (K, N) int8 *
// scale (N,)), the weight dequantized on chip, so no float copy of it ever
// exists in device memory.  Two arithmetics, picked per call:
//   f32:  w = float(q) * s in f32, products summed in f32 -- the arithmetic of
//         JAX's weight-only FaceExtraction (dequantize_tree, then a Dense);
//   bf16: the TPU kernel's rounding chain: x rounded to bf16, w = bf16(q) *
//         bf16(s) rounded to bf16, the products (exact in f32) summed in f32.
// int8 widens to float exactly (|q| <= 127), roundings use __float2bfloat16_rn,
// and the file builds with -fmad=false: the accumulation is an explicit fmaf.
//
// What bounds it on this card.  At IResNet-50's fc in f32 mode, (8, 25088,
// 512): q is 12.85 MB, x 0.80 MB, scale and output 0.02 MB: 13.67 MB, 4.08 us
// at 3.35 TB/s; 205.5 MFLOP take 3.07 us at the 67 TFLOP/s f32 rate.  So it is
// bound by memory: the int8 weight stream.  At M = 1 the bound is the 12.85 MB
// of q alone.
//
// What the design does about it.  The TPU grid tiles N only and holds the
// whole K block in VMEM; at N = 512 that would be 4 CTAs on 132 SMs.  Here
// the grid is (N / 128 column tiles) x (K chunks) x (M / 8 row tiles), with
// the number of K chunks chosen by the wrapper to give about one CTA for each
// SM (33 chunks of 768 rows at the fc's shape: 132 CTAs, one wave; at about
// 200 registers a thread, one CTA of 256 threads fills an SM):
//   * a CTA stages its x chunk (8 rows x kc, zeros past M; bf16-rounded in
//     bf16 mode) in shared memory once;
//   * a warp is 8 column groups x 4 rows: each lane streams 16 int8 of one q
//     row with one 16-byte load (neighbouring lanes on neighbouring bytes, a
//     warp reads four full 128-byte rows), four rows ahead, dequantizes them
//     in registers and accumulates its 8 x 16 outputs in f32;
//   * the 32 row lanes that share a column group are summed in a fixed
//     order: two xor shuffles inside the warp, then the 8 warps in order
//     through shared memory;
//   * each CTA writes its partial (M x 128) tile to a workspace; a second
//     kernel sums the K chunks in chunk order.  No atomics: a repeated call
//     gives the same bits.
// A column count N that is not a multiple of 16 (or a q not 16-byte
// aligned) takes byte loads with per-column bounds.  M == 1 has its own instance with
// one accumulator row.  mma/wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;                  // columns per lane: one 16-byte load of q
constexpr int kBN = 128;                   // columns per CTA
constexpr int kGroups = kBN / kCols;       // lanes across a row: 8
constexpr int kRows = kThreads / kGroups;  // q rows per step of the CTA: 32
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                 // q rows in flight per lane
constexpr int kMaxKC = 1024;               // rows per K chunk, at most

static_assert(kMaxKC == kWarps * kBN, "the x tile's buffer is reused for the warp sums");

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Byte j of a word, sign-extended: the int8 value, exactly.
__device__ __forceinline__ float int8_at(uint32_t word, int j) {
  return static_cast<float>(static_cast<int>(word << (24 - 8 * j)) >> 24);
}

template <bool VEC>
__device__ __forceinline__ uint4 load_q(const int8_t* __restrict__ row, int c0, int N) {
  if (VEC) return __ldg(reinterpret_cast<const uint4*>(row + c0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    if (c0 + j < N) w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(row + c0 + j))) << (8 * (j % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int MT, bool BF16, bool VEC>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_splitk(const float* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, float* __restrict__ dst, int M,
                       int K, int N, int kc) {
  __shared__ float smem[MT * kMaxKC];  // x tile [MT][kc], then the warp sums
  const int n0 = blockIdx.x * kBN;
  const int k0 = blockIdx.y * kc;
  const int rows = min(kc, K - k0);
  const int m0 = blockIdx.z * MT;

  for (int i = threadIdx.x; i < MT * rows; i += kThreads) {
    const int m = i / rows, k = i - m * rows;
    const float v = (m0 + m < M) ? x[static_cast<size_t>(m0 + m) * K + k0 + k] : 0.f;
    smem[m * kc + k] = BF16 ? round_bf16(v) : v;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane % kGroups;              // column group
  const int r = warp * 4 + lane / kGroups;   // row lane, 0..31
  const int c0 = n0 + g * kCols;

  float s[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const float v = (c0 + c < N) ? scale[c0 + c] : 0.f;
    s[c] = BF16 ? round_bf16(v) : v;
  }
  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;
  __syncthreads();

  if (c0 < N) {
    const int8_t* qk = q + static_cast<size_t>(k0) * N;
    for (int kb = r; kb < rows; kb += kRows * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kb + u * kRows;
        v[u] = k < rows ? load_q<VEC>(qk + static_cast<size_t>(k) * N, c0, N) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = kb + u * kRows;
        if (k >= rows) break;
        const uint32_t words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        float w[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float wf = int8_at(words[c / 4], c % 4) * s[c];
          w[c] = BF16 ? round_bf16(wf) : wf;
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = smem[m * kc + k];
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
        }
      }
    }
  }

  // The four row lanes of a warp that share a column group, in a fixed order.
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float t = acc[m][c];
      t += __shfl_xor_sync(0xffffffffu, t, 8);
      t += __shfl_xor_sync(0xffffffffu, t, 16);
      acc[m][c] = t;
    }
  __syncthreads();  // the x tile is dead: its buffer takes the warp sums
  if (lane < kGroups) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) smem[(warp * MT + m) * kBN + g * kCols + c] = acc[m][c];
  }
  __syncthreads();
  float* out = dst + static_cast<size_t>(blockIdx.y) * M * N;
  for (int i = threadIdx.x; i < MT * kBN; i += kThreads) {
    const int m = i / kBN, c = i % kBN;
    if (m0 + m >= M || n0 + c >= N) continue;
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += smem[(w * MT + m) * kBN + c];
    out[static_cast<size_t>(m0 + m) * N + n0 + c] = t;
  }
}

// out[i] = sum over the K chunks, in chunk order, of part[chunk][i].
__global__ void __launch_bounds__(kThreads)
    sum_chunks(const float* __restrict__ part, float* __restrict__ out, long long mn, int chunks) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < mn;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    float t = 0.f;
    for (int s = 0; s < chunks; ++s) t += part[s * mn + i];
    out[i] = t;
  }
}

template <int MT, bool BF16>
void launch_splitk(dim3 grid, cudaStream_t stream, bool vec, const float* x, const int8_t* q,
                   const float* scale, float* dst, int M, int K, int N, int kc) {
  if (vec)
    int8_matmul_splitk<MT, BF16, true><<<grid, kThreads, 0, stream>>>(x, q, scale, dst, M, K, N, kc);
  else
    int8_matmul_splitk<MT, BF16, false><<<grid, kThreads, 0, stream>>>(x, q, scale, dst, M, K, N, kc);
}

}  // namespace

// x (M, K) f32, q (K, N) int8 and scale (N,) f32, all contiguous on one device;
// out (M, N) f32.  The K axis is cut into ceil(K / kc) chunks of kc rows (kc a
// multiple of 32, at most 1024); with more than one chunk, `partial` holds
// chunks * M * N floats.  vec: N % 16 == 0 and q 16-byte aligned.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int rsfd_int8_matmul(const float* x, const int8_t* q, const float* scale, float* out,
                                float* partial, int M, int K, int N, int kc, int bf16, int vec,
                                void* stream_ptr) {
  if (M <= 0 || K <= 0 || N <= 0 || kc <= 0 || kc > kMaxKC || kc % kRows) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int chunks = (K + kc - 1) / kc;
  const int mt = M == 1 ? 1 : 8;
  const dim3 grid((N + kBN - 1) / kBN, chunks, (M + mt - 1) / mt);
  float* dst = chunks == 1 ? out : partial;
  if (mt == 1) {
    if (bf16) launch_splitk<1, true>(grid, stream, vec, x, q, scale, dst, M, K, N, kc);
    else launch_splitk<1, false>(grid, stream, vec, x, q, scale, dst, M, K, N, kc);
  } else {
    if (bf16) launch_splitk<8, true>(grid, stream, vec, x, q, scale, dst, M, K, N, kc);
    else launch_splitk<8, false>(grid, stream, vec, x, q, scale, dst, M, K, N, kc);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const long long mn = static_cast<long long>(M) * N;
  const int blocks = static_cast<int>(std::min((mn + kThreads - 1) / kThreads, 4096LL));
  sum_chunks<<<blocks, kThreads, 0, stream>>>(partial, out, mn, chunks);
  return cudaGetLastError();
}
