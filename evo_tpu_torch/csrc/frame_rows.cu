// The frame's update of the patch table's rows in one launch, a block a row:
// pyramidal Lucas-Kanade for the rows that were just inserted, their flow
// initialisation, then the border-lost check and the event budget of every
// live row against the frame's new gradient pair.
//
// Replaces `evo_tpu/tracker/detector.py::_lk_init_cond` (:230) over
// `evo_tpu/kernels/lk.py::pyramidal_lk` (:121, its level `_track_level`
// :38 and that level's `while_loop` :107), `_apply_flow_init` (:248) and
// `evo_tpu/tracker/align.py::update_num_of_events` (:461): XLA device code,
// no Pallas kernel. Its plain PyTorch version is
// `evo_tpu_torch/tracker/detector.py::frame_rows_ref` (`kernels.lk.
// track_pyramids_ref`, `apply_flow_init`, `align.update_num_of_events_ref`),
// whose arithmetic this file follows.
//
// What bounds it: latency. A new row's LK is up to 3 x 30 trips in series,
// each a 21x21 resampling of a window and a block reduction; the bytes (two
// windows of 16 KB a level) and the operations (~150 a sample a trip) are
// microseconds of the card for 128 rows. So the row stays on chip, one
// sample a thread: the level's two windows (at most 64x64, 45x45 at level 2
// of a 180-row frame) in shared memory, the template and its derivative
// images in each sample thread's registers, a trip's two sums by the block
// reduction of `row_budget.cuh`, and every thread takes the same step from
// the sums (the same bits in every thread). No host read decides anything:
// a row that runs no LK skips it, a frame without new rows finishes at once.
// The budget is `align_step.cu`'s stage 5 (`row_budget.cuh`).
//
// A row's result depends on its own inputs alone; its sums run in one fixed
// order whatever the number of rows. The window's origin rounds half to
// even (`rintf`, as `torch.round`); taps outside the window weigh 0, as the
// plain version's dense matrices have no column there. Built with
// -fmad=false, so each product and sum rounds on its own.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

#include "row_budget.cuh"

namespace {

constexpr int kLkWin = 64;     // `kernels/lk.py::LK_WINDOW`
constexpr int kMaxLevels = 3;
constexpr float kEps2 = 1e-4f;  // OpenCV's eps 0.01, squared
constexpr float kDetMin = 1e-7f;
constexpr float kTwuScale = 1.0f;  // `align.TIME_WITHOUT_UPDATE_SCALE`

// The entry's arguments (`kernels/frame_rows.py`)
struct Args {
  const unsigned char *alive, *initialized;
  const float *center, *warp, *flow, *twu;
  const int* num_of_events;
  const float* prev[kMaxLevels];  // the previous frame's pyramid, levels 0..levels-1
  const float* cur[kMaxLevels];   // this frame's
  const float* grad;              // [2, H, W]
  unsigned char *alive_out, *initialized_out;
  float *warp_out, *flow_out, *twu_out;
  int* num_of_events_out;
  float* lk_flow;                 // [P, 2] or null
  unsigned char* lk_status;       // [P] or null
  int* lk_trips;                  // [P, kMaxLevels] or null
  float* lk_d2;                   // [P, kMaxLevels] or null: each level's last |dv|^2
  int P, H, W, levels, radius, iters, with_lk;
};

struct Shared {
  float part[kGroups][17];
  float sums[16];
  float w0[kLkWin * kLkWin];  // the previous frame's window at this level
  float w1[kLkWin * kLkWin];  // this frame's
};

// `interp.cubic_taps_vd` / `cubic_taps` in a window of `size`: the taps'
// indices, Catmull-Rom weights and (with dw) their slopes; a tap outside
// the window weighs 0; a non-finite coordinate takes base 0, as
// `nan_to_num` there
__device__ __forceinline__ void lk_taps(float coord, int size, int idx[4], float w[4],
                                        float* dw) {
  const float c = isfinite(coord) ? coord : 0.0f;
  const float base = floorf(fminf(fmaxf(c, -8.0f), (float)size + 8.0f));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float pos = base + (float)(k - 1);
    const bool valid = pos >= 0.0f && pos < (float)size;
    const float d = coord - pos;
    const float ad = fabsf(d);
    const float near_v = ((1.5f * ad - 2.5f) * ad) * ad + 1.0f;
    const float far_v = ((-0.5f * ad + 2.5f) * ad - 4.0f) * ad + 2.0f;
    const float v = ad <= 1.0f ? near_v : (ad < 2.0f ? far_v : 0.0f);
    idx[k] = (int)fminf(fmaxf(pos, 0.0f), (float)(size - 1));
    w[k] = valid ? v : 0.0f;
    if (dw) {
      const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : (d != d ? d : 0.0f));
      const float near_d = (4.5f * ad - 5.0f) * ad;
      const float far_d = (-1.5f * ad + 5.0f) * ad - 4.0f;
      const float dv = sgn * (ad <= 1.0f ? near_d : (ad < 2.0f ? far_d : 0.0f));
      dw[k] = valid ? dv : 0.0f;
    }
  }
}

// Σ_kx (Σ_ky win[iy][ix] wy) wx: the rows' taps first, then the columns'
// (`interp.sample_grid`)
__device__ __forceinline__ float sample(const float* win, int size, const int iy[4],
                                        const float wy[4], const int ix[4], const float wx[4]) {
  float acc = 0.0f;
#pragma unroll
  for (int kx = 0; kx < 4; ++kx) {
    float col = 0.0f;
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) col = col + win[iy[ky] * size + ix[kx]] * wy[ky];
    acc = acc + col * wx[kx];
  }
  return acc;
}

// round(c) less half, clamped to [0, hi] (`lk._origin`); NaN at 0
__device__ __forceinline__ int lk_origin(float c, int half, int hi) {
  const float r = rintf(c);
  long long v = (r != r) ? 0LL : (long long)fmaxf(fminf(r, 1e9f), -1e9f);
  v -= half;
  if (v < 0) v = 0;
  if (v > hi) v = hi;
  return (int)v;
}

__device__ void load_window(float* dst, const float* img, int w, int oy, int ox, int side) {
  for (int i = threadIdx.x; i < side * side; i += kThreads)
    dst[i] = img[(size_t)(oy + i / side) * w + ox + i % side];
}

// One level of LK for the row's point pt0 from the guess (`lk._track_level`):
// the flow v and whether the level's track holds
__device__ void track_level(Shared& sh, const float* img0, const float* img1, int h, int w,
                            float p0x, float p0y, float gx0, float gy0, int radius, int iters,
                            float& vx, float& vy, bool& ok, int& trips, float& last_d2) {
  const int side = min(kLkWin, min(h, w));
  const int half = side / 2;
  const int S = 2 * radius + 1;
  const int t = threadIdx.x;
  const bool mine = t < S * S;
  const float ra = (float)(t / S - radius), rb = (float)(t % S - radius);  // row, column offsets

  const int ox0 = lk_origin(p0x, half, w - side), oy0 = lk_origin(p0y, half, h - side);
  const int ox1 = lk_origin(p0x + gx0, half, w - side), oy1 = lk_origin(p0y + gy0, half, h - side);
  __syncthreads();  // the previous level's windows are read no more
  load_window(sh.w0, img0, w, oy0, ox0, side);
  load_window(sh.w1, img1, w, oy1, ox1, side);
  __syncthreads();

  // the template and its derivative images at this thread's sample
  float tv = 0.0f, gxv = 0.0f, gyv = 0.0f;
  if (mine) {
    const float x0 = (p0x - (float)ox0) + rb, y0 = (p0y - (float)oy0) + ra;
    int ix[4], iy[4];
    float wx[4], dwx[4], wy[4], dwy[4];
    lk_taps(x0, side, ix, wx, dwx);
    lk_taps(y0, side, iy, wy, dwy);
    tv = sample(sh.w0, side, iy, wy, ix, wx);
    gxv = sample(sh.w0, side, iy, wy, ix, dwx);
    gyv = sample(sh.w0, side, iy, dwy, ix, wx);
  }
  float a[kPix][3] = {{gxv * gxv, gxv * gyv, gyv * gyv}};
  block_reduce(a, sh, Add());
  const float a11 = sh.sums[0], a12 = sh.sums[1], a22 = sh.sums[2];
  const float det = a11 * a22 - a12 * a12;
  const bool ok_grad = det > kDetMin;
  const float det_safe = ok_grad ? det : 1.0f;

  const float bx1 = (p0x - (float)ox1) + rb, by1 = (p0y - (float)oy1) + ra;
  vx = gx0;
  vy = gy0;
  float d2 = INFINITY;
  int it = 0;
  while (it < iters && d2 >= kEps2) {
    float e = 0.0f;
    if (mine) {
      int ix[4], iy[4];
      float wx[4], wy[4];
      lk_taps(bx1 + vx, side, ix, wx, nullptr);
      lk_taps(by1 + vy, side, iy, wy, nullptr);
      e = sample(sh.w1, side, iy, wy, ix, wx) - tv;
    }
    float b[kPix][2] = {{e * gxv, e * gyv}};
    block_reduce(b, sh, Add());
    const float b1 = sh.sums[0], b2 = sh.sums[1];
    const float dvx = -(a22 * b1 - a12 * b2) / det_safe;
    const float dvy = -(-a12 * b1 + a11 * b2) / det_safe;
    vx = vx + dvx;
    vy = vy + dvy;
    d2 = dvx * dvx + dvy * dvy;
    ++it;
  }
  // the target window is anchored at pt0 + guess: an iterate that travels
  // beyond its slack samples clamped window edges, so it fails
  const float slack = (float)(half - radius - 1);
  const bool ok_travel = fabsf(vx - gx0) <= slack && fabsf(vy - gy0) <= slack;
  ok = ok_grad && isfinite(vx) && isfinite(vy) && ok_travel;
  trips = it;
  last_d2 = d2;
}

__global__ void __launch_bounds__(kThreads) frame_rows_kernel(Args a) {
  __shared__ Shared sh;
  const int p = blockIdx.x, tid = threadIdx.x;
  const float cx = a.center[2 * p], cy = a.center[2 * p + 1];
  bool alive = a.alive[p] != 0, init = a.initialized[p] != 0;
  float warp[4];
  for (int k = 0; k < 4; ++k) warp[k] = a.warp[4 * p + k];
  float flow = a.flow[p], twu = a.twu[p];
  int noe = a.num_of_events[p];

  // 1. LK of the rows just inserted (`pyramidal_lk`), all levels here
  const bool track = a.with_lk && alive && !init;
  float fx = 0.0f, fy = 0.0f;
  bool status = track;
  if (tid == 0 && a.lk_trips)
    for (int k = 0; k < kMaxLevels; ++k) {  // levels that do not run: 0 trips
      a.lk_trips[kMaxLevels * p + k] = 0;
      a.lk_d2[kMaxLevels * p + k] = 0.0f;
    }
  if (track) {
    for (int lvl = a.levels - 1; lvl >= 0; --lvl) {
      const float scale = (float)(1 << lvl);
      int h = a.H, w = a.W;
      for (int k = 0; k < lvl; ++k) {
        h = (h + 1) / 2;
        w = (w + 1) / 2;
      }
      float vx, vy, d2;
      bool ok;
      int trips;
      track_level(sh, a.prev[lvl], a.cur[lvl], h, w, cx / scale, cy / scale, fx / scale,
                  fy / scale, a.radius, a.iters, vx, vy, ok, trips, d2);
      fx = vx * scale;
      fy = vy * scale;
      status = status && ok;
      if (tid == 0 && a.lk_trips) {
        a.lk_trips[kMaxLevels * p + lvl] = trips;
        a.lk_d2[kMaxLevels * p + lvl] = d2;
      }
    }
    const float nx = cx + fx, ny = cy + fy;
    status = status && nx >= 1.0f && nx < (float)(a.W - 1) && ny >= 1.0f
             && ny < (float)(a.H - 1);
  }
  if (tid == 0 && a.lk_flow) {
    a.lk_flow[2 * p] = fx;
    a.lk_flow[2 * p + 1] = fy;
    a.lk_status[p] = status;
  }

  // 2. the flow initialisation of those rows (`apply_flow_init`)
  if (track) {
    const bool border_lost = cx <= (float)kLostBorder || cy <= (float)kLostBorder
                             || cx >= (float)(a.W - kLostBorder)
                             || cy >= (float)(a.H - kLostBorder);
    const bool ok = status && !border_lost;
    if (!ok) alive = false;
    if (ok) {
      init = true;
      warp[0] = 1.0f;
      warp[1] = 0.0f;
      warp[2] = -fx;
      warp[3] = -fy;
      flow = atan2f(fy, fx);
      const float speed = sqrtf(fx * fx + fy * fy);
      twu = kTwuScale / clamp_min(speed, 0.1f);
    }
  }

  // 3. the border-lost check and the budget of every live row
  // (`update_num_of_events`), row_budget.cuh's device code
  {
    bool border = false;
    if (alive) {
      const BudgetWindow bw = budget_window(warp, cx, cy, flow, a.H, a.W);
      float l1[kPix][1];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const int q = tid + k * kThreads;
        l1[k][0] = q < kPixels ? budget_term(q, warp, cx, cy, bw, a.grad, a.H, a.W) : 0.0f;
      }
      block_reduce(l1, sh, Add());
      int budget;
      budget_decision(sh.sums[0], cx, cy, a.H, a.W, budget, border);
      if (!border) noe = budget;
    }
    alive = alive && !border;
  }
  if (tid == 0) {
    a.alive_out[p] = alive;
    a.initialized_out[p] = init;
    for (int k = 0; k < 4; ++k) a.warp_out[4 * p + k] = warp[k];
    a.flow_out[p] = flow;
    a.twu_out[p] = twu;
    a.num_of_events_out[p] = noe;
  }
}

}  // namespace

// One launch over the P rows. `ptrs` holds the Args pointers in their order
// (`kernels/frame_rows.py::POINTERS`); the LK diagnostics may be null, and
// the pyramids are read with with_lk only. levels <= 3, (2 radius + 1)^2 <= 640.
extern "C" int evo_frame_rows(const void* const* ptrs, int P, int H, int W, int levels,
                              int radius, int iters, int with_lk, void* stream) {
  if (P == 0) return (int)cudaSuccess;
  if (levels < 1 || levels > kMaxLevels || (2 * radius + 1) * (2 * radius + 1) > kThreads)
    return (int)cudaErrorInvalidValue;
  Args a;
  memcpy(&a, ptrs, offsetof(Args, P));
  a.P = P;
  a.H = H;
  a.W = W;
  a.levels = levels;
  a.radius = radius;
  a.iters = iters;
  a.with_lk = with_lk;
  frame_rows_kernel<<<P, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
