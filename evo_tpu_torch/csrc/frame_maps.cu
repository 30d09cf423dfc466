// A frame's maps in one launch: the log/Sobel gradient pair, the Harris
// response and levels 1 and 2 of the Gaussian pyramid.
//
// Replaces `evo_tpu/kernels/gradients.py::sobel` of `log_image` (:21, :44;
// `evo_tpu/tracker/detector.py:143` `_compute_grads`), `evo_tpu/kernels/
// harris.py::harris_response` (:25) and `gradients.py::image_pyramid` (:80),
// XLA convolutions shaped for the TPU: no Pallas kernel. Their plain
// PyTorch versions are `evo_tpu_torch/kernels/frame_maps.py::frame_maps_ref`
// (conv2d chains), whose arithmetic this file follows:
// - gradients: Sobel/8 of log(I + 0.1), zero-padded 'same' correlation;
// - Harris: Sobel/4 of I, its three products, each zero outside the image,
//   their 3x3 box sums, det - 0.04 tr^2;
// - pyramid: a 5-tap Gaussian (sigma 1, the plain version's own weights,
//   passed in) along x, then along y, zero padding, then [::2, ::2]; level 2
//   from level 1 the same way.
//
// What bounds it: bytes. The frame is read once (173 KB at 240x180) and
// 3.3 frames' worth written; ~200 operations a pixel is far below the card's
// rate. So one launch does it all, a block a 32x32 tile of level-0 pixels
// with a halo of 6 in shared memory (what level 2 reaches through two blurs
// and two decimations), and writes the tile's 16x16 level-1 and 8x8 level-2
// pixels too; the level-1 pixels of the halo are recomputed by each block
// that needs them, with the same arithmetic, so with the same bits. Each
// intermediate (log, products, the blurs' row passes) stays in shared memory.
//
// Built with -fmad=false, so each product and sum rounds on its own; the
// sums run in the taps' order (cuDNN's order is its own: the plain version
// and this kernel agree to ~1e-7 on [0, 1] images).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;                 // level-0 pixels a block, a side
constexpr int kHalo = 6;                  // the pyramid's reach at level 0
constexpr int kIn = kTile + 2 * kHalo;    // 44: the image tile
constexpr int kP = kTile + 2;             // 34: log and products, halo 1
constexpr int kR1 = kTile / 2 + 3;        // 19: level-1 pixels a side, halo 2 before, 1 after
constexpr int kRows0 = 2 * kR1 + 3;       // 41: level-0 rows the level-1 row pass reads
constexpr int kT2 = kTile / 4;            // 8: level-2 pixels a block, a side
constexpr int kThreads = 256;

struct Shared {
  float img[kIn][kIn];       // I at level-0 (o - 6 + j, o - 6 + i), 0 outside
  float lg[kP][kP];          // log(I + 0.1) at (o - 1 + j, o - 1 + i), 0 outside
  float pxx[kP][kP], pyy[kP][kP], pxy[kP][kP];  // Harris products, 0 outside
  float r0[kRows0][kR1];     // level 0's row pass at the level-1 columns
  float l1[kR1][kR1];        // level 1 at (o1 - 2 + r, o1 - 2 + c), 0 outside
  float r1[kR1][kT2];        // level 1's row pass at the level-2 columns
};

__device__ __forceinline__ float sobel_x(const float* p, int stride) {
  // [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], correlation, rows in order
  const float a = -p[0] + p[2];
  const float b = -2.0f * p[stride] + 2.0f * p[stride + 2];
  const float c = -p[2 * stride] + p[2 * stride + 2];
  return (a + b) + c;
}

__device__ __forceinline__ float sobel_y(const float* p, int stride) {
  // [[-1, -2, -1], [0, 0, 0], [1, 2, 1]]
  const float a = (-p[0] + -2.0f * p[1]) + -p[2];
  const float c = (p[2 * stride] + 2.0f * p[2 * stride + 1]) + p[2 * stride + 2];
  return a + c;
}

__global__ void __launch_bounds__(kThreads)
frame_maps_kernel(const float* __restrict__ image, const float* __restrict__ gauss,
                  float* __restrict__ grad, float* __restrict__ resp,
                  float* __restrict__ lvl1, float* __restrict__ lvl2, int H, int W) {
  __shared__ Shared sh;
  const int tid = threadIdx.x;
  const int oy = blockIdx.y * kTile, ox = blockIdx.x * kTile;
  const int H1 = (H + 1) / 2, W1 = (W + 1) / 2, H2 = (H1 + 1) / 2, W2 = (W1 + 1) / 2;
  const int oy1 = oy / 2, ox1 = ox / 2, oy2 = oy / 4, ox2 = ox / 4;
  float g[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) g[k] = gauss[k];

  // the image tile with its halo, 0 outside the image
  for (int i = tid; i < kIn * kIn; i += kThreads) {
    const int y = oy - kHalo + i / kIn, x = ox - kHalo + i % kIn;
    sh.img[i / kIn][i % kIn] = (y >= 0 && y < H && x >= 0 && x < W) ? image[(size_t)y * W + x]
                                                                    : 0.0f;
  }
  __syncthreads();

  // log(I + 0.1) and the Harris products at halo 1, each 0 outside the image
  for (int i = tid; i < kP * kP; i += kThreads) {
    const int j = i / kP, c = i % kP;
    const int y = oy - 1 + j, x = ox - 1 + c;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const float* p = &sh.img[j + kHalo - 2][c + kHalo - 2];  // the 3x3 around (y, x)
    const float gx = sobel_x(p, kIn) * 0.25f, gy = sobel_y(p, kIn) * 0.25f;
    sh.lg[j][c] = in ? logf(sh.img[j + kHalo - 1][c + kHalo - 1] + 0.1f) : 0.0f;
    sh.pxx[j][c] = in ? gx * gx : 0.0f;
    sh.pyy[j][c] = in ? gy * gy : 0.0f;
    sh.pxy[j][c] = in ? gx * gy : 0.0f;
  }
  // level 0's row pass (along x) at the level-1 columns the tile's level-1
  // pixels and their halo need: level-0 row oy - 6 + j, column 2 (ox1 - 2 + c)
  for (int i = tid; i < kRows0 * kR1; i += kThreads) {
    const int j = i / kR1, c = i % kR1;
    const int y = oy - kHalo + j;
    float acc = 0.0f;
    if (y >= 0 && y < H) {
      const float* p = &sh.img[j][2 * c + 2 - 2];  // columns 2 (ox1 - 2 + c) - 2 .. + 2
#pragma unroll
      for (int k = 0; k < 5; ++k) acc = acc + p[k] * g[k];
    }
    sh.r0[j][c] = acc;
  }
  __syncthreads();

  // the tile's gradients and response
  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int j = i / kTile, c = i % kTile;
    const int y = oy + j, x = ox + c;
    if (y >= H || x >= W) continue;
    const float* p = &sh.lg[j][c];
    const size_t at = (size_t)y * W + x;
    grad[at] = sobel_x(p, kP) * 0.125f;
    grad[(size_t)H * W + at] = sobel_y(p, kP) * 0.125f;
    float sxx = 0.0f, syy = 0.0f, sxy = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        sxx = sxx + sh.pxx[j + a][c + b];
        syy = syy + sh.pyy[j + a][c + b];
        sxy = sxy + sh.pxy[j + a][c + b];
      }
    const float det = sxx * syy - sxy * sxy;
    const float tr = sxx + syy;
    resp[at] = det - (0.04f * tr) * tr;
  }
  // level 1 (the column pass of level 0's row pass) over the tile and its halo
  for (int i = tid; i < kR1 * kR1; i += kThreads) {
    const int r = i / kR1, c = i % kR1;
    const int y1 = oy1 - 2 + r, x1 = ox1 - 2 + c;
    float acc = 0.0f;
    if (y1 >= 0 && y1 < H1 && x1 >= 0 && x1 < W1) {
#pragma unroll
      for (int k = 0; k < 5; ++k) acc = acc + sh.r0[2 * r + k][c] * g[k];
    }
    sh.l1[r][c] = acc;
    if (r >= 2 && r < 2 + kTile / 2 && c >= 2 && c < 2 + kTile / 2 && y1 < H1 && x1 < W1)
      lvl1[(size_t)y1 * W1 + x1] = acc;
  }
  __syncthreads();

  // level 1's row pass at the level-2 columns: level-1 row oy1 - 2 + r,
  // column 2 (ox2 + c) = ox1 + 2 c
  for (int i = tid; i < kR1 * kT2; i += kThreads) {
    const int r = i / kT2, c = i % kT2;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 5; ++k) acc = acc + sh.l1[r][2 * c + k] * g[k];
    sh.r1[r][c] = acc;
  }
  __syncthreads();
  for (int i = tid; i < kT2 * kT2; i += kThreads) {
    const int a = i / kT2, b = i % kT2;
    const int y2 = oy2 + a, x2 = ox2 + b;
    if (y2 >= H2 || x2 >= W2) continue;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 5; ++k) acc = acc + sh.r1[2 * a + k][b] * g[k];
    lvl2[(size_t)y2 * W2 + x2] = acc;
  }
}

}  // namespace

// The maps of image [H, W] float32: grad [2, H, W], resp [H, W], lvl1
// [(H + 1) / 2, (W + 1) / 2], lvl2 [(H1 + 1) / 2, (W1 + 1) / 2]; gauss [5]
// the Gaussian's taps. One launch, a block a 32x32 tile.
extern "C" int evo_frame_maps(const void* image, const void* gauss, void* grad, void* resp,
                              void* lvl1, void* lvl2, int H, int W, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaSuccess;
  dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile);
  frame_maps_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)image, (const float*)gauss, (float*)grad, (float*)resp, (float*)lvl1,
      (float*)lvl2, H, W);
  return (int)cudaGetLastError();
}
