// A patch-table row's event budget, shared by `align_step.cu` (the re-budget
// of the rows that just solved, its stage 5) and `frame_rows.cu` (the
// frame's re-budget of every live row), so the two compute it with the same
// device code: the L1 norm of the row's warped, flow-projected gradients over
// its 25 x 25 rect, x0.6, bilinear taps of the 64 x 64 window around the
// warped centre (`evo_tpu_torch/tracker/align.py::budgets`), then the clamp,
// the border-lost test and the rect's out-of-image rule (`_set_budgets`,
// `_border_masks`).
//
// One rect pixel a thread, 640 threads a row (`kThreads`), and one block
// sum in a fixed order (`block_reduce`: a butterfly in each warp, then the
// warps' partials in order), so a row's budget depends on its own inputs
// alone, whatever kernel computes it.
//
// Its helpers live in an anonymous namespace, the includer's own: include it
// once, before the includer's code.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

// tracker/patch_state.py and tracker/align.py
constexpr int kExtent = 12;                // PATCH_EXTENT
constexpr int kSide = 2 * kExtent + 1;     // PATCH_SIDE
constexpr int kPixels = kSide * kSide;
constexpr int kWin = 64;                   // GRAD_WINDOW
constexpr int kInitEvents = 75;            // INIT_NUM_EVENTS
constexpr int kMinEvents = 100;            // MIN_NUM_EVENTS
constexpr int kMaxEvents = 300;            // MAX_NUM_EVENTS
constexpr int kLostBorder = 5;
constexpr float kBudgetScale = 0.6f;

constexpr int kThreads = 640;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = (kPixels + kThreads - 1) / kThreads;  // rect pixels a thread: 1
constexpr int kGroups = kPix * kWarps;  // groups of 32 consecutive rect pixels
static_assert(kThreads % 32 == 0 && kGroups * 32 >= kPixels, "whole warps");

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamp_min(float v, float lo) {  // keeps NaN
  return v < lo ? lo : v;
}

// round(c) as an integer, less half the window, clamped into the image
// (`slice_grad_window`); a NaN converts to 0 as on the card
__device__ __forceinline__ int window_origin(float c, int size) {
  float r = rintf(c);
  long long v = (r != r) ? 0LL : (long long)fmaxf(fminf(r, 1e9f), -1e9f);
  v -= kWin / 2;
  if (v < 0) v = 0;
  if (v > size - kWin) v = size - kWin;
  return (int)v;
}

// `interp._tap_positions`: floor of the coordinate with its non-finite
// values at 0 and clamped to [-8, size + 8]
__device__ __forceinline__ float tap_base(float coord) {
  float c = isfinite(coord) ? coord : 0.0f;
  return floorf(fminf(fmaxf(c, -8.0f), (float)kWin + 8.0f));
}

__device__ __forceinline__ int tap_index(float pos) {
  return (int)fminf(fmaxf(pos, 0.0f), (float)(kWin - 1));
}

// `interp.linear_taps`: hat weights
__device__ __forceinline__ void linear_taps(float coord, int idx[2], float w[2]) {
  const float base = tap_base(coord);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float pos = base + (float)k;
    const bool valid = pos >= 0.0f && pos < (float)kWin;
    const float d = coord - pos;
    idx[k] = tap_index(pos);
    w[k] = valid ? clamp_min(1.0f - fabsf(d), 0.0f) : 0.0f;
  }
}

// ---- geometry (core/lie.py) ----------------------------------------------

__device__ __forceinline__ void se2_apply(const float* g, float px, float py,
                                          float& ox, float& oy) {
  ox = (g[0] * px - g[1] * py) + g[2];
  oy = (g[1] * px + g[0] * py) + g[3];
}

struct Add {
  __device__ float operator()(int, float a, float b) const { return a + b; }
};

// Reduces v[k][0..N) (value i of the thread's k-th pixel) over the block
// into sh.sums[0..N) by op(i, a, b), in a fixed order: a butterfly in the
// warp, then the groups (warps) in order. `Sh` has `part[kGroups][>= N]`
// and `sums[>= N]` in shared memory. Every thread must call it; the sums are
// readable after it returns until the next reduction's first barrier.
template <int N, class Op, class Sh>
__device__ void block_reduce(float (&v)[kPix][N], Sh& sh, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kPix; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[k][i] = op(i, v[k][i], __shfl_xor_sync(kFull, v[k][i], off));
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kPix; ++k)
#pragma unroll
      for (int i = 0; i < N; ++i) sh.part[warp + k * kWarps][i] = v[k][i];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    const int i = threadIdx.x;
    float acc = sh.part[0][i];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) acc = op(i, acc, sh.part[g][i]);
    sh.sums[i] = acc;
  }
  __syncthreads();
}

// ---- the budget ------------------------------------------------------------

// Where a row's budget samples: the window's origin around the warped
// centre, and the sine and cosine of the flow angle
struct BudgetWindow {
  int ox, oy;
  float fs, fc;
};

__device__ __forceinline__ BudgetWindow budget_window(const float* warp, float cx, float cy,
                                                      float flow, int H, int W) {
  float wcx, wcy;
  se2_apply(warp, cx, cy, wcx, wcy);
  BudgetWindow bw;
  bw.ox = window_origin(wcx, W);
  bw.oy = window_origin(wcy, H);
  sincosf(flow, &bw.fs, &bw.fc);
  return bw;
}

// |0.6 g(W q) . (cos f, sin f)| at rect pixel q of a row centred at (cx, cy),
// g the gradient pair grad [2, H, W] read through L2
__device__ __forceinline__ float budget_term(int q, const float* warp, float cx, float cy,
                                             const BudgetWindow& bw, const float* grad,
                                             int H, int W) {
  const float qx = (float)(q % kSide) + (cx - (float)kExtent);
  const float qy = (float)(q / kSide) + (cy - (float)kExtent);
  float wx, wy;
  se2_apply(warp, qx, qy, wx, wy);
  int iy[2], ix[2];
  float ty[2], tx[2];
  linear_taps(wy - (float)bw.oy, iy, ty);
  linear_taps(wx - (float)bw.ox, ix, tx);
  float gch[2];
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const float* plane = grad + ((size_t)ch * H + bw.oy) * W + bw.ox;
    float v = 0.0f;
#pragma unroll
    for (int kx = 0; kx < 2; ++kx) {
      float row = 0.0f;
#pragma unroll
      for (int ky = 0; ky < 2; ++ky)
        row = row + __ldg(plane + (size_t)iy[ky] * W + ix[kx]) * ty[ky];
      v = v + row * tx[kx];
    }
    gch[ch] = v;
  }
  return fabsf(kBudgetScale * (gch[0] * bw.fc + gch[1] * bw.fs));
}

// The budget from the rect's sum `raw` (clamped to [100, 300], truncated as
// `.to(int32)`, NaN to 100; 75 where the rect leaves the image) and whether
// the centre lies within 5 px of the border (lost)
__device__ __forceinline__ void budget_decision(float raw, float cx, float cy, int H, int W,
                                                int& budget, bool& border) {
  const float hf = (float)H, wf = (float)W;
  border = cx <= (float)kLostBorder || cy <= (float)kLostBorder
           || cx >= (float)(W - kLostBorder) || cy >= (float)(H - kLostBorder);
  const float ntx = cx - (float)kExtent, nty = cy - (float)kExtent;
  const bool rect_oob = ntx < 0.0f || nty < 0.0f || ntx + (float)kSide >= wf
                        || nty + (float)kSide >= hf;
  int b;
  if (raw != raw || raw < (float)kMinEvents) b = kMinEvents;  // NaN: 100, as clamped
  else if (raw >= (float)kMaxEvents) b = kMaxEvents;
  else b = (int)raw;  // truncation, as .to(int32)
  budget = rect_oob ? kInitEvents : b;
}

}  // namespace
