// Fused ResNet-50 stem for Hopper (sm_90a): K2.
//
// Replaces the Pallas TPU kernel rs_face_detection_tpu/ops/stem_pallas.py::
// fused_stem_s2d (body _stem_kernel), with the same folded constants
// (ops/stem.py::fold_stem_params).  In one pass per output tile:
//   1. read the letterboxed (B, H, W, 3) uint8 BGR canvas directly -- the 2x2
//      space-to-depth channel k = (bi*2 + bj)*3 + c is pixel (2i+bi, 2j+bj, c),
//      so no s2d copy exists -- and normalize it, (float(px) - mean[k]) *
//      scale[k];  a pixel outside the frame is 0 AFTER normalizing (the conv
//      zero-pads the normalized frame, not the uint8 one);
//   2. the 4x4/s1 conv with block pad (2, 1) over 12 channels, which in pixel
//      space is an 8x8/s2 conv with pad (4, 2) over 3 channels: 192
//      products per output, summed in f32;
//   3. eval BatchNorm as scale and shift, then ReLU;
//   4. the 3x3/s2 max-pool with pad 1 (post-ReLU values are >= 0, so the
//      pool's padding is the sentinel -1);
//   5. write the pooled (B, 64, ceil(H/4), ceil(W/4)) f32 NCHW tile.
// Any even H and W: the Pallas kernel's H/2 % 16, W/2 % 4 limit came from
// TPU tiling, not from the math.  The wrapper (kernels/stem.py) refuses odd
// sizes.
//
// What bounds it on this card: the f32 FMA rate.  At b8 x 640 the conv is
// 8 x 320 x 320 x 64 x 192 = 10.1 G multiply-adds against 9.8 MB of uint8 in
// and 52 MB of f32 out: about 170 FMAs per byte moved, far above the card's
// f32 ridge.  The (B, 64, H/2, W/2) pre-pool tensor, 210 MB in f32 at b8 x
// 640, never reaches device memory: that is the point of the kernel.
// What the design does about it:
//   * persistent CTAs of 192 threads, two per SM (108,736 B of dynamic
//     shared memory each: weights, input window and conv tile, below); each
//     stages the 48 KB of weights into shared memory once, then walks tiles
//     of 4 x 8 pooled outputs;
//   * a tile's 24 x 46 x 3 input window, normalized, sits in shared memory;
//     its 9 x 17 conv outputs (x 64 channels) are computed into shared
//     memory, the one conv row and column shared with the next tile being
//     recomputed there rather than exchanged;
//   * a thread owns 4 conv columns x 8 channels: per tap it reads 4 inputs
//     and two float4 weights from shared memory for 32 FMAs.
// The dot products use explicit fmaf; the file builds with -fmad=false, so
// the normalize and the BatchNorm round every product and sum on their own,
// as the plain version (ops/stem.py::fused_stem_plain) does.  Only the
// conv's summation order differs from the plain version.  Tensor cores
// (TF32 or bf16 mma/wgmma) and TMA are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 192;
constexpr int kOut = 64;                         // output channels
constexpr int kTP = 4;                           // pooled rows per tile
constexpr int kTQ = 8;                           // pooled cols per tile
constexpr int kCR = 2 * kTP + 1;                 // conv rows per tile (9)
constexpr int kCC = 2 * kTQ + 1;                 // conv cols per tile (17)
constexpr int kColGroup = 4;                     // conv cols per thread item
constexpr int kCG = (kCC + kColGroup - 1) / kColGroup;  // col groups (5)
constexpr int kCCP = kCG * kColGroup;            // padded conv cols (20)
constexpr int kChanGroup = 8;                    // channels per thread item
constexpr int kNG = kOut / kChanGroup;           // channel groups (8)
constexpr int kXR = 2 * (kCR - 1) + 8;           // input pixel rows (24)
constexpr int kXC = 2 * (kCCP - 1) + 8;          // input pixel cols (46)
constexpr int kTaps = 8 * 8 * 3;                 // pixel-space taps (192)
constexpr int kConvStride = kCR * kCCP + 1;      // floats per channel plane
constexpr size_t kSmemBytes =
    sizeof(float) * ((size_t)kTaps * kOut + kXR * kXC * 3 + kOut * kConvStride);

__global__ void __launch_bounds__(kThreads, 2)
fused_stem_kernel(const uint8_t* __restrict__ canvas,
                  const float* __restrict__ w192,
                  const float* __restrict__ bn2,
                  const float* __restrict__ norm2,
                  float* __restrict__ out, int B, int H, int W, int Hp, int Wp,
                  int tiles_y, int tiles_x) {
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                        // [(u*8 + v)*3 + c][64]
  float* s_x = s_w + kTaps * kOut;          // [kXR][kXC][3]
  float* s_conv = s_x + kXR * kXC * 3;      // [64][kConvStride]
  const int H2 = H / 2, W2 = W / 2;

  // w192 row (dy*4 + dx)*12 + (bi*2 + bj)*3 + c is pixel tap (2dy+bi, 2dx+bj, c).
  for (int i = threadIdx.x; i < kTaps * kOut; i += kThreads) {
    const int o = i % kOut;
    const int row = i / kOut;
    const int c = row % 3, blk = (row / 3) % 4, dyx = row / 12;
    const int u = 2 * (dyx / 4) + blk / 2, v = 2 * (dyx % 4) + blk % 2;
    s_w[((u * 8 + v) * 3 + c) * kOut + o] = w192[i];
  }

  const int per_image = tiles_y * tiles_x;
  const int n_tiles = B * per_image;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / per_image;
    const int t = tile - b * per_image;
    const int py0 = (t / tiles_x) * kTP, px0 = (t % tiles_x) * kTQ;
    // Local conv row r is conv row 2*py0 - 1 + r; it reads pixel rows
    // 2*(2*py0 - 1 + r) - 4 + u for u in 0..7, so the window starts here.
    const int y0 = 4 * py0 - 6, x0 = 4 * px0 - 6;
    __syncthreads();  // weights staged; the previous tile's readers are done

    const uint8_t* img = canvas + (size_t)b * H * W * 3;
    for (int i = threadIdx.x; i < kXR * kXC * 3; i += kThreads) {
      const int c = i % 3, col = (i / 3) % kXC, row = i / (3 * kXC);
      const int gy = y0 + row, gx = x0 + col;
      float val = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int k = ((gy & 1) * 2 + (gx & 1)) * 3 + c;
        val = __fmul_rn(__fsub_rn((float)img[((size_t)gy * W + gx) * 3 + c], norm2[k]),
                        norm2[12 + k]);
      }
      s_x[i] = val;
    }
    __syncthreads();

    for (int item = threadIdx.x; item < kCR * kCG * kNG; item += kThreads) {
      const int g = item % kNG;
      const int cg = (item / kNG) % kCG;
      const int r = item / (kNG * kCG);
      float acc[kColGroup][kChanGroup];
#pragma unroll
      for (int j = 0; j < kColGroup; ++j) {
#pragma unroll
        for (int i = 0; i < kChanGroup; ++i) acc[j][i] = 0.0f;
      }
      const float* xbase = s_x + (2 * r) * kXC * 3 + (2 * cg * kColGroup) * 3;
      const float* wbase = s_w + g * kChanGroup;
      for (int u = 0; u < 8; ++u) {
        const float* xrow = xbase + u * kXC * 3;
#pragma unroll
        for (int v = 0; v < 8; ++v) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float4* wp =
                reinterpret_cast<const float4*>(wbase + ((u * 8 + v) * 3 + c) * kOut);
            const float4 wa = wp[0], wb = wp[1];
#pragma unroll
            for (int j = 0; j < kColGroup; ++j) {
              const float xv = xrow[(2 * j + v) * 3 + c];
              acc[j][0] = __fmaf_rn(xv, wa.x, acc[j][0]);
              acc[j][1] = __fmaf_rn(xv, wa.y, acc[j][1]);
              acc[j][2] = __fmaf_rn(xv, wa.z, acc[j][2]);
              acc[j][3] = __fmaf_rn(xv, wa.w, acc[j][3]);
              acc[j][4] = __fmaf_rn(xv, wb.x, acc[j][4]);
              acc[j][5] = __fmaf_rn(xv, wb.y, acc[j][5]);
              acc[j][6] = __fmaf_rn(xv, wb.z, acc[j][6]);
              acc[j][7] = __fmaf_rn(xv, wb.w, acc[j][7]);
            }
          }
        }
      }
      const int gr = 2 * py0 - 1 + r;
#pragma unroll
      for (int j = 0; j < kColGroup; ++j) {
        const int cc = cg * kColGroup + j;
        const int gc = 2 * px0 - 1 + cc;
        const bool inside = gr >= 0 && gr < H2 && gc >= 0 && gc < W2;
#pragma unroll
        for (int i = 0; i < kChanGroup; ++i) {
          const int o = g * kChanGroup + i;
          const float y = fmaxf(__fadd_rn(__fmul_rn(acc[j][i], bn2[o]), bn2[kOut + o]), 0.0f);
          s_conv[o * kConvStride + r * kCCP + cc] = inside ? y : -1.0f;
        }
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < kOut * kTP * kTQ; i += kThreads) {
      const int q = i % kTQ, p = (i / kTQ) % kTP, o = i / (kTP * kTQ);
      const int py = py0 + p, px = px0 + q;
      if (py >= Hp || px >= Wp) continue;
      const float* cp = s_conv + o * kConvStride + (2 * p) * kCCP + 2 * q;
      float m = cp[0];
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) m = fmaxf(m, cp[dr * kCCP + dc]);
      }
      out[(((size_t)b * kOut + o) * Hp + py) * Wp + px] = m;
    }
  }
}

}  // namespace

extern "C" {

// canvas (B, H, W, 3) u8, w192 (192, 64), bn2 (2, 64), norm2 (2, 12) f32;
// out (B, 64, Hp, Wp) f32 with Hp = (H/2 - 1)/2 + 1, Wp likewise.  Launches
// on `stream` and returns cudaGetLastError() (0 on success).
int rsfd_fused_stem(const uint8_t* canvas, const float* w192, const float* bn2,
                    const float* norm2, float* out, int B, int H, int W, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || (H & 1) || (W & 1)) return (int)cudaErrorInvalidValue;
  const int Hp = (H / 2 - 1) / 2 + 1, Wp = (W / 2 - 1) / 2 + 1;
  const int tiles_y = (Hp + kTP - 1) / kTP, tiles_x = (Wp + kTQ - 1) / kTQ;
  const long long n_tiles = (long long)B * tiles_y * tiles_x;
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_stem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return (int)err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_stem_kernel, kThreads,
                                                           kSmemBytes)) != cudaSuccess) {
    return (int)err;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)sms * per_sm;
  const int grid = (int)(n_tiles < resident ? n_tiles : resident);
  fused_stem_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      canvas, w192, bn2, norm2, out, B, H, W, Hp, Wp, tiles_y, tiles_x);
  return (int)cudaGetLastError();
}

}  // extern "C"
