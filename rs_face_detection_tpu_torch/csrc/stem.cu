// Fused ResNet-50 stem for Hopper (sm_90a): K2.
//
// Replaces the Pallas TPU kernel rs_face_detection_tpu/ops/stem_pallas.py::
// fused_stem_s2d (body _stem_kernel), with the same folded constants
// (ops/stem.py::fold_stem_params).  In one pass per output tile:
//   1. read the letterboxed (B, H, W, 3) uint8 BGR canvas directly -- the 2x2
//      space-to-depth channel k = (bi*2 + bj)*3 + c is pixel (2i+bi, 2j+bj, c),
//      so no s2d copy exists;
//   2. the 4x4/s1 conv with block pad (2, 1) over 12 normalized channels,
//      which in pixel space is an 8x8/s2 conv with pad (4, 2) over 3
//      channels: 192 taps per output; a pixel outside the frame is 0 AFTER
//      normalizing (the conv zero-pads the normalized frame, not the uint8
//      one);
//   3. eval BatchNorm as scale and shift, then ReLU;
//   4. the 3x3/s2 max-pool with pad 1 (post-ReLU values are >= 0, so the
//      pool's padding is the sentinel -1);
//   5. write the pooled (B, 64, ceil(H/4), ceil(W/4)) f32 NCHW tile.
// Any even H and W: the Pallas kernel's H/2 % 16, W/2 % 4 limit came from
// TPU tiling, not from the math.  The wrapper (kernels/stem.py) refuses odd
// sizes.
//
// The conv on the tensor cores, at f32 accuracy, in two TF32 products per
// tap.  With x = (px - mean_k) * scale_k, the conv of an output is
//   sum_{taps in the frame} w x = sum_in w' px - corr,  w' = w * scale_k,
//   corr = sum_{taps in the frame} w' mean_k.
// px is an integer 0..255, exact in TF32, so A = px needs no split; w' is
// split as hi = cvt.rna.tf32(w'), lo = cvt.rna.tf32(w' - hi) (22 bits), and
// acc += px.w'_lo + px.w'_hi on mma.sync.m16n8k8.tf32 with f32
// accumulation: every product is exact.  A tap outside the frame reads px =
// 0, and corr depends only on how many of the 8 window rows and columns
// fall outside the frame (0, 2 or 4 at the top or left, 0 or 2 at the
// bottom or right): 36 patterns x 64 channels, summed once per CTA from the
// folded constants.  The tolerance against the plain version (1e-5 of the
// output's magnitude) rules out one TF32 pass; 3xTF32 on a split
// normalized input would take three products per tap.  mma.sync, not
// wgmma: wgmma's A from shared memory must be a plain tiled matrix, not
// this overlapping gather of the window, and wgmma has no transposed
// operands for tf32.
//
// The conv as an implicit GEMM.  For one conv row the product is
// A (conv columns x 192 taps) . W' (192 taps x 64 channels).  Tap (u, v, c)
// of conv column j reads window pixel (2r + u, 2j + v, c); with the window
// stored [row][col][c], A(j, u*24 + kk) is s_x[2r + u][6j + kk] for
// kk = 3v + c, so A's fragments are gathered straight from shared memory.
//
// What bounds it on this card: the tensor cores.  At b8 x 640 the conv is
// 8 x 320 x 320 x 64 x 192 = 10.1 G multiply-adds, 20.1 GFLOP; the two
// products per tap make 40.3 GFLOP, 0.081 ms at 495 TFLOP/s, the kernel's
// bound (3xTF32 would need 60.4 GFLOP, 0.122 ms).  The bytes are 9.8 MB of
// uint8 in and 52.4 MB of f32 out, 0.0186 ms.  The (B, 64, H/2, W/2)
// pre-pool tensor, 210 MB in f32 at b8 x 640, never reaches device memory.
// What the design does:
//   * persistent CTAs of 9 warps, one per SM (dynamic shared memory: weight
//     fragments, input window, conv tile and the corrections); each stages
//     w' once, already split and laid out as B fragments (one 16-byte load
//     gives a lane both halves of both its rows), then walks tiles of 4 x 15
//     pooled outputs;
//   * a tile's 24 x 70 x 3 input window sits in shared memory as floats;
//     its bytes are loaded into registers during the previous tile's
//     products.  Warp r computes conv row r of the tile's 9 x 32 conv
//     outputs (two 16-column m-tiles x 64 channels: 2 x 8 accumulator
//     fragments, accumulated over all 192 taps by the tensor cores) and
//     writes them, after the correction, BatchNorm and ReLU, to the conv
//     tile in shared memory (a channel pitch of 292 floats: the fragment
//     stores hit 32 distinct banks); the pool reads the tile.  The one conv
//     row and the one conv column shared with the next tile are recomputed
//     (9 x 32 conv outputs for 8 x 30: 20% more products), and the 32nd
//     column is computed and not used.
// Only the conv's summation differs from the plain version
// (ops/stem.py::fused_stem_plain): the file builds with -fmad=false, and the
// BatchNorm rounds its product and sum on their own (__fmul_rn, __fadd_rn),
// as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 9;
constexpr int kThreads = 32 * kWarps;
constexpr int kOut = 64;                         // output channels
constexpr int kTP = 4;                           // pooled rows per tile
constexpr int kTQ = 15;                          // pooled cols per tile
constexpr int kCR = 2 * kTP + 1;                 // conv rows per tile (9), one per warp
constexpr int kCC = 32;                          // conv cols per tile (2 m-tiles; 31 used)
constexpr int kXR = 2 * (kCR - 1) + 8;           // input pixel rows (24)
constexpr int kXC = 2 * (kCC - 1) + 8;           // input pixel cols (70)
constexpr int kXP = kXC * 3;                     // floats per window row (210)
constexpr int kTaps = 8 * 8 * 3;                 // pixel-space taps (192)
constexpr int kKSteps = kTaps / 8;               // mma k-steps (24), 3 per window row
constexpr int kNT = kOut / 8;                    // mma n-tiles (8)
constexpr int kConvStride = kCR * kCC + 4;       // floats per channel plane (292)
constexpr int kPatterns = 3 * 2 * 3 * 2;         // window cuts: top, bottom, left, right
constexpr int kXPer = (kXR * kXP + kThreads - 1) / kThreads;  // window floats per thread (18)
constexpr size_t kSmemBytes = sizeof(float) * ((size_t)kKSteps * kNT * 32 * 4 + kXR * kXP +
                                               kOut * kConvStride + 2 * kOut + kPatterns * kOut);
static_assert(kCR == kWarps, "one warp per conv row");
static_assert(2 * kTQ + 1 <= kCC, "the pool's conv columns fit the tile");
static_assert(64 * kOut <= kOut * kConvStride, "the per-tap corrections fit the conv tile");

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo + O(2^-22 x), both halves tf32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// D (16x8, f32) += A (16x8, tf32, row) . B (8x8, tf32, col).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pixel tap (u, v, c) of the 8x8/s2 conv: its w192 row and its s2d channel.
__device__ __forceinline__ int tap_row(int u, int v, int c) {
  return ((u / 2) * 4 + v / 2) * 12 + ((u & 1) * 2 + (v & 1)) * 3 + c;
}
__device__ __forceinline__ int tap_channel(int u, int v, int c) {
  return ((u & 1) * 2 + (v & 1)) * 3 + c;
}

// The raw bytes of tile `tile`'s window, kXPer per thread (-1 outside the
// frame).  Local conv row r is conv row 2*py0 - 1 + r; it reads pixel rows
// 2*(2*py0 - 1 + r) - 4 + u for u in 0..7, so the window starts at
// 4*py0 - 6 (and likewise for columns).
__device__ __forceinline__ void fetch_window(int (&raw)[kXPer], const uint8_t* __restrict__ canvas,
                                             int tile, int per_image, int tiles_x, int H, int W,
                                             int tid) {
  const int b = tile / per_image, tt = tile - b * per_image;
  const int y0 = 4 * (tt / tiles_x) * kTP - 6, x0 = 4 * (tt % tiles_x) * kTQ - 6;
  const uint8_t* img = canvas + (size_t)b * H * W * 3;
#pragma unroll
  for (int j = 0; j < kXPer; ++j) {
    const int i = tid + j * kThreads;
    const int c = i % 3, col = (i / 3) % kXC, row = i / kXP;
    const int gy = y0 + row, gx = x0 + col;
    raw[j] = i < kXR * kXP && gy >= 0 && gy < H && gx >= 0 && gx < W
                 ? (int)img[((size_t)gy * W + gx) * 3 + c]
                 : -1;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_stem_kernel(const uint8_t* __restrict__ canvas,
                  const float* __restrict__ w192,
                  const float* __restrict__ bn2,
                  const float* __restrict__ norm2,
                  float* __restrict__ out, int B, int H, int W, int Hp, int Wp,
                  int tiles_y, int tiles_x) {
  extern __shared__ __align__(16) float smem[];
  float4* s_wf = reinterpret_cast<float4*>(smem);   // [k-step][n-tile][lane]
  float* s_x = smem + kKSteps * kNT * 32 * 4;       // [kXR][kXC][3]
  float* s_conv = s_x + kXR * kXP;                  // [64][kConvStride]
  float* s_bn = s_conv + kOut * kConvStride;        // scale[64], shift[64]
  float* s_corr = s_bn + 2 * kOut;                  // [pattern][64]
  const int H2 = H / 2, W2 = W / 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column

  // B fragments: lane (g, t) of k-step ks, n-tile nt holds W'[8ks + t][8nt + g]
  // and W'[8ks + t + 4][8nt + g], tf32 hi and lo, where pixel tap
  // kp = (u*8 + v)*3 + c is w192 row tap_row(u, v, c) scaled by its channel's
  // normalize scale.
  for (int i = tid; i < kKSteps * kNT * 32; i += kThreads) {
    const int l = i & 31, nt = (i >> 5) % kNT, ks = i / (32 * kNT);
    const int n = 8 * nt + (l >> 2);
    float w[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kp = 8 * ks + (l & 3) + 4 * e;
      const int u = kp / 24, v = (kp % 24) / 3, c = kp % 3;
      w[e] = __fmul_rn(w192[tap_row(u, v, c) * kOut + n], norm2[12 + tap_channel(u, v, c)]);
    }
    uint32_t h0, l0, h1, l1;
    split_tf32(w[0], h0, l0);
    split_tf32(w[1], h1, l1);
    s_wf[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                          __uint_as_float(l1));
  }
  for (int i = tid; i < 2 * kOut; i += kThreads) s_bn[i] = bn2[i];
  // corr: m[u][v][n] = sum_c w' mean (in the conv tile, free until the first
  // tile), then per pattern the sum over the window rows and columns inside
  // the frame, in a fixed order.
  float* s_m = s_conv;
  for (int i = tid; i < 64 * kOut; i += kThreads) {
    const int n = i % kOut, uv = i / kOut, u = uv / 8, v = uv % 8;
    float sum = 0.0f;
    for (int c = 0; c < 3; ++c) {
      const int k = tap_channel(u, v, c);
      sum = __fadd_rn(sum, __fmul_rn(__fmul_rn(w192[tap_row(u, v, c) * kOut + n], norm2[12 + k]), norm2[k]));
    }
    s_m[i] = sum;
  }
  __syncthreads();
  for (int i = tid; i < kPatterns * kOut; i += kThreads) {
    const int n = i % kOut, p = i / kOut;
    const int right = p & 1, left = (p >> 1) % 3, bottom = (p / 6) & 1, top = p / 12;
    float sum = 0.0f;
    for (int u = 2 * top; u < 8 - 2 * bottom; ++u) {
      for (int v = 2 * left; v < 8 - 2 * right; ++v) sum = __fadd_rn(sum, s_m[(u * 8 + v) * kOut + n]);
    }
    s_corr[i] = sum;
  }

  const int per_image = tiles_y * tiles_x;
  const int n_tiles = B * per_image;
  // The next tile's window bytes are loaded while this one's products run.
  int raw[kXPer];
  if ((int)blockIdx.x < n_tiles) fetch_window(raw, canvas, blockIdx.x, per_image, tiles_x, H, W, tid);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / per_image;
    const int tt = tile - b * per_image;
    const int py0 = (tt / tiles_x) * kTP, px0 = (tt % tiles_x) * kTQ;
    __syncthreads();  // constants staged; the previous tile's readers are done

    // The window as floats: the pixel value, exact, or 0 outside the frame.
#pragma unroll
    for (int j = 0; j < kXPer; ++j) {
      const int i = tid + j * kThreads;
      if (i < kXR * kXP) s_x[i] = raw[j] < 0 ? 0.0f : (float)raw[j];
    }
    __syncthreads();
    if (tile + (int)gridDim.x < n_tiles) {
      fetch_window(raw, canvas, tile + gridDim.x, per_image, tiles_x, H, W, tid);
    }

    // Warp r: conv row r, conv columns 0..31 (m-tiles mt = 0, 1), 64 channels.
    const int r = warp;
    float acc[2][kNT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float* xr = s_x + (2 * r + u) * kXP + 6 * g + t;
#pragma unroll
      for (int ks3 = 0; ks3 < 3; ++ks3) {
        // A fragments: (col g, tap t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        // of m-tile mt; conv column j is 6j floats into the window row.  An
        // integer pixel value is its own tf32 bit pattern.
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* xa = xr + 96 * mt + 8 * ks3;
          a[mt][0] = __float_as_uint(xa[0]);
          a[mt][1] = __float_as_uint(xa[48]);
          a[mt][2] = __float_as_uint(xa[4]);
          a[mt][3] = __float_as_uint(xa[52]);
        }
        const float4* wf = s_wf + (u * 3 + ks3) * kNT * 32 + lane;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float4 w = wf[nt * 32];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_tf32(acc[mt][nt], a[mt], __float_as_uint(w.z), __float_as_uint(w.w));
            mma_tf32(acc[mt][nt], a[mt], __float_as_uint(w.x), __float_as_uint(w.y));
          }
        }
      }
    }

    // Correction, BatchNorm and ReLU on the accumulator fragments, into the
    // conv tile; a conv position outside the (H/2, W/2) grid is the pool's
    // pad (-1).  Window rows 2*gr - 4 + u outside 0..H-1 are cut: 4 or 2 at
    // the top for conv rows 0 and 1, 2 at the bottom for the last.
    const int gr = 2 * py0 - 1 + r;
    const bool row_in = gr >= 0 && gr < H2;
    const int top = max(0, 2 - gr), bottom = max(0, 2 * gr + 4 - H) / 2;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = 16 * mt + g + 8 * half;
        const int gc = 2 * px0 - 1 + col;
        const bool inside = row_in && gc >= 0 && gc < W2;
        const int left = max(0, 2 - gc), right = max(0, 2 * gc + 4 - W) / 2;
        const float* corr = s_corr + (((top * 2 + bottom) * 3 + left) * 2 + right) * kOut;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = 8 * nt + 2 * t + e;
            float y = 0.0f;
            if (inside) {
              const float conv = __fsub_rn(acc[mt][nt][2 * half + e], corr[o]);
              y = fmaxf(__fadd_rn(__fmul_rn(conv, s_bn[o]), s_bn[kOut + o]), 0.0f);
            }
            s_conv[o * kConvStride + r * kCC + col] = inside ? y : -1.0f;
          }
        }
      }
    }
    __syncthreads();

    for (int i = tid; i < kOut * kTP * kTQ; i += kThreads) {
      const int q = i % kTQ, p = (i / kTQ) % kTP, o = i / (kTP * kTQ);
      const int py = py0 + p, px = px0 + q;
      if (py >= Hp || px >= Wp) continue;
      const float* cp = s_conv + o * kConvStride + (2 * p) * kCC + 2 * q;
      float m = cp[0];
#pragma unroll
      for (int dr = 0; dr < 3; ++dr) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc) m = fmaxf(m, cp[dr * kCC + dc]);
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
