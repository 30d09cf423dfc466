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
// microseconds of the card for 128 rows, and the slowest row sets the
// launch. So the row stays on chip and its chain is kept short:
//  - the windows are fetched ahead, as asynchronous copies
//    (`__pipeline_memcpy_async`) into dynamic shared memory, their rows
//    padded so that a warp's samples read 32 banks: every level's
//    template (it depends on the row's point alone: the (2 radius + 6)^2
//    floats of its window that its taps read, stored alone) and the coarsest level's
//    target window at the block's start, each finer level's target window
//    (whole: the iterate may travel anywhere in it) as soon as the coarser
//    level's flow is known, while the level's template is sampled;
//  - a sample a thread (samples a thread in a loop where (2 radius + 1)^2 is
//    more than the block: any radius up to kMaxRadius), the template and its
//    derivative images in registers;
//  - the Catmull-Rom taps depend on a sample's column or row alone: 2 S
//    threads compute a trip's 2 S tap sets once, into a table in shared
//    memory, and every sample reads its own (the bits its own call gives);
//  - a trip's two barriers are `row_budget.cuh`'s `block_reduce`'s, in its
//    order (the sums keep its bits): after the first, the table's threads
//    add the warps' partials, take the step and fill the table with the
//    next trip's taps; after the second, every thread reads the new
//    iterate. (One barrier a trip, with each warp adding the 20
//    partials itself, was slower on the card: every warp then reads them
//    all through the shared-memory pipe that the samples' loads share.)
// No host read decides anything: a row that runs no LK skips it, a frame
// without new rows finishes at once. The budget is `align_step.cu`'s stage 5
// (`row_budget.cuh`).
//
// A row's result depends on its own inputs alone; its sums run in one fixed
// order whatever the number of rows. The window's origin rounds half to
// even (`rintf`, as `torch.round`); taps outside the window weigh 0, as the
// plain version's dense matrices have no column there. Built with
// -fmad=false, so each product and sum rounds on its own.
//
// The clock build (-DEVO_FR_CLOCKS, a library of its own) writes each row's
// clock64() cycles by stage into `clocks` [P, kStages] (`Stage`,
// `kernels.frame_rows.STAGES`); the plain build ignores the pointer.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

#include <mutex>

#include "row_budget.cuh"

namespace {

constexpr int kLkWin = 64;     // `kernels/lk.py::LK_WINDOW`
// a target window in shared memory, its rows `window_stride` floats apart
constexpr int kWinFloats = kLkWin * (kLkWin + 31);
constexpr int kMaxLevels = 3;
// the widest window whose travel slack at a full 64 px window is not
// negative (`lk._track_level`: half - radius - 1); beyond it no row tracks
constexpr int kMaxRadius = kLkWin / 2 - 1;
constexpr int kMaxS = 2 * kMaxRadius + 1;  // the sample grid's side
constexpr int kMaxSamples = (kMaxS * kMaxS + kThreads - 1) / kThreads;
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
  long long* clocks;              // [P, kStages] or null: the clock build's cycles
  int P, H, W, levels, radius, iters, with_lk;
};

// Stage clock (-DEVO_FR_CLOCKS only): thread 0 adds the clock64() cycles
// since the previous mark into a stage's bin. MARK comes after a barrier
// (one of its own: the clock build has one more a trip, between the
// sampling and the sums), so a stage's time is its slowest thread's; STAMP
// follows a barrier the kernel has anyway.
enum Stage { kWindows, kTemplate, kSampling, kSums, kBudget, kWrite, kTotal, kStages };
struct Clock {
  long long last, start, bins[kStages];
};
#ifdef EVO_FR_CLOCKS
__device__ void stamp(Clock& clk, int stage) {
  if (threadIdx.x == 0) {
    const long long t = clock64();
    clk.bins[stage] += t - clk.last;
    clk.last = t;
  }
}
#define STAMP(clk, stage) stamp(clk, stage)
#define MARK(clk, stage) (__syncthreads(), stamp(clk, stage))
#else
#define STAMP(clk, stage) ((void)0)
#define MARK(clk, stage) ((void)0)
#endif

// The trip's (or the template's) taps, one set a column of the S x S sample
// grid and one a row, in shared memory: they depend on the column's or the
// row's coordinate alone, so 2 S threads compute them once for the block
// and every sample reads its own; with kD also the slopes
struct TapTable {
  int bx[kMaxS], by[kMaxS];
  float4 wx[kMaxS], wy[kMaxS], dwx[kMaxS], dwy[kMaxS];
};

struct Shared {
  float part[kGroups][17];  // `block_reduce`'s and the trips' partials
  float sums[16];
  TapTable tab;
};

// `interp.cubic_taps_vd` / `cubic_taps` in a window of `size`: the taps'
// base (the window index of tap 1, before the clamp), Catmull-Rom weights
// and (with kD) their slopes; a tap outside the window weighs 0; a
// non-finite coordinate takes base 0, as `nan_to_num` there
template <bool kD>
__device__ __forceinline__ int lk_taps(float coord, int size, float w[4], float dw[4]) {
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
    w[k] = valid ? v : 0.0f;
    if (kD) {
      const float sgn = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : (d != d ? d : 0.0f));
      const float near_d = (4.5f * ad - 5.0f) * ad;
      const float far_d = (-1.5f * ad + 5.0f) * ad - 4.0f;
      const float dv = sgn * (ad <= 1.0f ? near_d : (ad < 2.0f ? far_d : 0.0f));
      dw[k] = valid ? dv : 0.0f;
    }
  }
  return (int)base;
}

// the four taps' window indices from the base, clamped into the window
__device__ __forceinline__ void tap_index(int base, int size, int idx[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) idx[k] = min(max(base + k - 1, 0), size - 1);
}

// thread t < 2 S computes column t's taps from xcol(t), or row t - S's from
// yrow(t - S), into the table
template <bool kD, class FX, class FY>
__device__ __forceinline__ void fill_taps(TapTable& tab, int S, int size, FX xcol, FY yrow) {
  const int t = threadIdx.x;
  if (t >= 2 * S) return;
  const bool col = t < S;
  float w[4], dw[4];
  const int base = lk_taps<kD>(col ? xcol(t) : yrow(t - S), size, w, dw);
  const int j = col ? t : t - S;
  (col ? tab.bx : tab.by)[j] = base;
  (col ? tab.wx : tab.wy)[j] = make_float4(w[0], w[1], w[2], w[3]);
  if (kD) (col ? tab.dwx : tab.dwy)[j] = make_float4(dw[0], dw[1], dw[2], dw[3]);
}

// the taps of the sample in column c, row r from the table
__device__ __forceinline__ void read_taps(const TapTable& tab, int c, int r, int size, int ix[4],
                                          int iy[4], float wx[4], float wy[4]) {
  tap_index(tab.bx[c], size, ix);
  tap_index(tab.by[r], size, iy);
  const float4 x = tab.wx[c], y = tab.wy[r];
  wx[0] = x.x, wx[1] = x.y, wx[2] = x.z, wx[3] = x.w;
  wy[0] = y.x, wy[1] = y.y, wy[2] = y.z, wy[3] = y.w;
}

// Σ_kx (Σ_ky win[iy][ix] wy) wx: the rows' taps first, then the columns'
// (`interp.sample_grid`); the window's rows `stride` floats apart
__device__ __forceinline__ float sample(const float* win, int stride, const int iy[4],
                                        const float wy[4], const int ix[4], const float wx[4]) {
  float acc = 0.0f;
#pragma unroll
  for (int kx = 0; kx < 4; ++kx) {
    float col = 0.0f;
#pragma unroll
    for (int ky = 0; ky < 4; ++ky) col = col + win[iy[ky] * stride + ix[kx]] * wy[ky];
    acc = acc + col * wx[kx];
  }
  return acc;
}

// The row stride of a side-wide window in shared memory for an S x S sample
// grid: the least at or above side that is S mod 32, so a warp's samples q
// (row q / S, column q % S) read banks q + constant mod 32, all 32 apart
__host__ __device__ __forceinline__ int window_stride(int side, int S) {
  return side + ((S - side) % 32 + 32) % 32;
}

// A template's part of its window, (S + 5)^2 floats at most
// (`template_span`), its rows `window_stride(S + 5, S)` apart
__host__ __device__ __forceinline__ int template_floats(int S) {
  return (S + 5) * window_stride(S + 5, S);
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

// Issues the asynchronous copies of rows r0..r1 and columns c0..c1 of the
// window at (oy, ox) of img (w columns) into dst, element (r0, c0) first,
// rows `stride` floats apart, a float a copy, consecutive threads on
// consecutive columns
__device__ void fetch_window(float* dst, int stride, const float* img, int w, int oy, int ox,
                             int r0, int r1, int c0, int c1) {
  const int cw = c1 - c0 + 1, n = (r1 - r0 + 1) * cw;
  const int dr = kThreads / cw, dc = kThreads - dr * cw;
  int r = (int)threadIdx.x / cw, c = (int)threadIdx.x % cw;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    __pipeline_memcpy_async(dst + r * stride + c,
                            img + (size_t)(oy + r0 + r) * w + ox + c0 + c, sizeof(float));
    r += dr;
    c += dc;
    if (c >= cw) {
      c -= cw;
      ++r;
    }
  }
}

// The rows (or columns) of a side-wide template window that its samples'
// taps read: floor(x0) - radius - 2 to floor(x0) + radius + 2 for the
// point's window coordinate x0, clamped; where x0 is not finite, the taps
// sit at 0 to 2
__device__ __forceinline__ void template_span(float x0, int radius, int side, int& lo,
                                              int& hi) {
  const int b = isfinite(x0) ? (int)floorf(fminf(fmaxf(x0, -1e6f), 1e6f)) : 0;
  lo = max(0, min(b - radius - 2, side - 1));
  hi = max(lo, min(b + radius + 2, side - 1));
}

// The trip's sums of the warps' partials part[0..groups) in `block_reduce`'s
// order; the later warps' partials, +0 there, are one +0 added at the end
__device__ __forceinline__ void trip_sums(const Shared& sh, int groups, float& b1, float& b2) {
  b1 = sh.part[0][0];
  b2 = sh.part[0][1];
#pragma unroll
  for (int g = 1; g < kGroups; ++g)
    if (g < groups) {
      b1 = b1 + sh.part[g][0];
      b2 = b2 + sh.part[g][1];
    }
  if (groups < kGroups) {
    b1 = b1 + 0.0f;
    b2 = b2 + 0.0f;
  }
}

// One level of LK for the row's point p0 from the guess g0 (`lk._track_level`)
// on its template win0 (landed: rows tr0.. and columns tc0.. of its window,
// its rows `tstride` apart) and its target window win1 (side x side, rows
// `stride` apart; the windows' origins o0 and o1; with `await_target` still in
// flight, awaited once the template is sampled): the flow v and whether the
// level's track holds. Each thread's samples are q = tid + k kThreads,
// k < NS. A trip: every sample reads its taps from the table and resamples
// the target window, the warps' butterflies, a barrier; then the 2 S
// threads of the table add the partials in `block_reduce`'s order, take the
// step and fill the table with the next trip's taps, a barrier; then every
// thread reads the new iterate.
template <int NS>
__device__ void track_level(Shared& sh, const float* win0, int tstride, int tr0, int tc0,
                            const float* win1, bool await_target, int side, int stride, int ox0,
                            int oy0, int ox1, int oy1, float p0x,
                            float p0y, float gx0, float gy0, int radius, int iters, float& vx,
                            float& vy, bool& ok, int& trips, float& last_d2, Clock& clk) {
  const int half = side / 2;
  const int S = 2 * radius + 1, n = S * S;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the warps that hold samples
  const int groups = min(kWarps, (min(n, kThreads) + 31) / 32);
  const bool active = warp < groups;
  int cq[NS], rq[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int q = tid + k * kThreads;
    rq[k] = q / S;
    cq[k] = q - rq[k] * S;
  }

  // the template and its derivative images at this thread's samples
  const float xc0 = p0x - (float)ox0, yc0 = p0y - (float)oy0;
  const float xc1 = p0x - (float)ox1, yc1 = p0y - (float)oy1;
  fill_taps<true>(sh.tab, S, side, [&](int c) { return xc0 + (float)(c - radius); },
                  [&](int r) { return yc0 + (float)(r - radius); });
  __syncthreads();
  float tv[NS], gxv[NS], gyv[NS];
  float a[kPix][3] = {{0.0f, 0.0f, 0.0f}};
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const bool mine = tid + k * kThreads < n;
    tv[k] = gxv[k] = gyv[k] = 0.0f;
    if (mine) {
      int ix[4], iy[4];
      float wx[4], wy[4], dwx[4], dwy[4];
      read_taps(sh.tab, cq[k], rq[k], side, ix, iy, wx, wy);
#pragma unroll
      for (int m = 0; m < 4; ++m) {  // into the template's part of the window
        ix[m] -= tc0;
        iy[m] -= tr0;
      }
      const float4 dx = sh.tab.dwx[cq[k]], dy = sh.tab.dwy[rq[k]];
      dwx[0] = dx.x, dwx[1] = dx.y, dwx[2] = dx.z, dwx[3] = dx.w;
      dwy[0] = dy.x, dwy[1] = dy.y, dwy[2] = dy.z, dwy[3] = dy.w;
      tv[k] = sample(win0, tstride, iy, wy, ix, wx);
      gxv[k] = sample(win0, tstride, iy, wy, ix, dwx);
      gyv[k] = sample(win0, tstride, iy, dwy, ix, wx);
    }
    if (k == 0) {
      a[0][0] = gxv[0] * gxv[0];
      a[0][1] = gxv[0] * gyv[0];
      a[0][2] = gyv[0] * gyv[0];
    } else if (mine) {
      a[0][0] = a[0][0] + gxv[k] * gxv[k];
      a[0][1] = a[0][1] + gxv[k] * gyv[k];
      a[0][2] = a[0][2] + gyv[k] * gyv[k];
    }
  }
  block_reduce(a, sh, Add());
  const float a11 = sh.sums[0], a12 = sh.sums[1], a22 = sh.sums[2];
  STAMP(clk, kTemplate);
  const float det = a11 * a22 - a12 * a12;
  const bool ok_grad = det > kDetMin;
  const float det_safe = ok_grad ? det : 1.0f;

  vx = gx0;
  vy = gy0;
  // the first trip's taps; the target window lands
  fill_taps<false>(sh.tab, S, side, [&](int c) { return (xc1 + (float)(c - radius)) + vx; },
                   [&](int r) { return (yc1 + (float)(r - radius)) + vy; });
  if (await_target) __pipeline_wait_prior(0);
  __syncthreads();
  STAMP(clk, kWindows);
  float d2 = INFINITY;
  int it = 0;
  while (it < iters && d2 >= kEps2) {
    float b[2] = {0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const bool mine = tid + k * kThreads < n;
      float e = 0.0f;
      if (mine) {
        int ix[4], iy[4];
        float wx[4], wy[4];
        read_taps(sh.tab, cq[k], rq[k], side, ix, iy, wx, wy);
        e = sample(win1, stride, iy, wy, ix, wx) - tv[k];
      }
      if (k == 0) {
        b[0] = e * gxv[0];
        b[1] = e * gyv[0];
      } else if (mine) {
        b[0] = b[0] + e * gxv[k];
        b[1] = b[1] + e * gyv[k];
      }
    }
    if (active) {  // `block_reduce`'s butterfly and partials
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) b[i] = b[i] + __shfl_xor_sync(kFull, b[i], off);
      if (lane == 0) {
        sh.part[warp][0] = b[0];
        sh.part[warp][1] = b[1];
      }
    }
    __syncthreads();
    STAMP(clk, kSampling);
    if (tid < 2 * S) {  // the sums, the step and the next trip's taps
      float b1, b2;
      trip_sums(sh, groups, b1, b2);
      const float dvx = -(a22 * b1 - a12 * b2) / det_safe;
      const float dvy = -(-a12 * b1 + a11 * b2) / det_safe;
      const float nx = vx + dvx, ny = vy + dvy, nd2 = dvx * dvx + dvy * dvy;
      if (tid == 0) {
        sh.sums[0] = nx;
        sh.sums[1] = ny;
        sh.sums[2] = nd2;
      }
      if (it + 1 < iters && nd2 >= kEps2)
        fill_taps<false>(sh.tab, S, side, [&](int c) { return (xc1 + (float)(c - radius)) + nx; },
                         [&](int r) { return (yc1 + (float)(r - radius)) + ny; });
    }
    __syncthreads();
    vx = sh.sums[0];
    vy = sh.sums[1];
    d2 = sh.sums[2];
    ++it;
    STAMP(clk, kSums);
  }
  // the target window is anchored at pt0 + guess: an iterate that travels
  // beyond its slack samples clamped window edges, so it fails
  const float slack = (float)(half - radius - 1);
  const bool ok_travel = fabsf(vx - gx0) <= slack && fabsf(vy - gy0) <= slack;
  ok = ok_grad && isfinite(vx) && isfinite(vy) && ok_travel;
  trips = it;
  last_d2 = d2;
}

// A level's size: level 0 is H x W, each next one ceil(half)
__device__ __forceinline__ void level_size(int H, int W, int lvl, int& h, int& w) {
  h = H;
  w = W;
  for (int k = 0; k < lvl; ++k) {
    h = (h + 1) / 2;
    w = (w + 1) / 2;
  }
}

template <int NS>
__global__ void __launch_bounds__(kThreads) frame_rows_kernel(Args a) {
  __shared__ Shared sh;
  // dynamic shared memory (with LK): the template window of each level,
  // then the target window
  extern __shared__ __align__(16) float dyn[];
  const int p = blockIdx.x, tid = threadIdx.x;
  const float cx = a.center[2 * p], cy = a.center[2 * p + 1];
  bool alive = a.alive[p] != 0, init = a.initialized[p] != 0;
  Clock clk;
#ifdef EVO_FR_CLOCKS
  if (tid == 0) {
    clk.start = clk.last = clock64();
    for (int k = 0; k < kStages; ++k) clk.bins[k] = 0;
  }
#endif

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
    const int S = 2 * a.radius + 1, tstride = window_stride(S + 5, S);
    float* tgt = dyn + a.levels * template_floats(S);
    // every level's template window, coarsest first, then with it the
    // coarsest level's target window (its guess is 0): a commit group a level
    for (int lvl = a.levels - 1; lvl >= 0; --lvl) {
      const float scale = (float)(1 << lvl);
      int h, w;
      level_size(a.H, a.W, lvl, h, w);
      const int side = min(kLkWin, min(h, w)), half = side / 2;
      const int stride = window_stride(side, S);
      const float p0x = cx / scale, p0y = cy / scale;
      const int ox0 = lk_origin(p0x, half, w - side), oy0 = lk_origin(p0y, half, h - side);
      int r0, r1, c0, c1;  // the template's samples read its window around the point alone
      template_span(p0y - (float)oy0, a.radius, side, r0, r1);
      template_span(p0x - (float)ox0, a.radius, side, c0, c1);
      fetch_window(dyn + lvl * template_floats(S), tstride, a.prev[lvl], w, oy0, ox0, r0, r1,
                   c0, c1);
      if (lvl == a.levels - 1)
        fetch_window(tgt, stride, a.cur[lvl], w, lk_origin(p0y + fy / scale, half, h - side),
                     lk_origin(p0x + fx / scale, half, w - side), 0, side - 1, 0, side - 1);
      __pipeline_commit();
    }
    for (int lvl = a.levels - 1; lvl >= 0; --lvl) {
      const float scale = (float)(1 << lvl);
      int h, w;
      level_size(a.H, a.W, lvl, h, w);
      const int side = min(kLkWin, min(h, w)), half = side / 2;
      const int stride = window_stride(side, S);
      const float p0x = cx / scale, p0y = cy / scale, gx0 = fx / scale, gy0 = fy / scale;
      const int ox0 = lk_origin(p0x, half, w - side), oy0 = lk_origin(p0y, half, h - side);
      const int ox1 = lk_origin(p0x + gx0, half, w - side);
      const int oy1 = lk_origin(p0y + gy0, half, h - side);
      int r0, r1, c0, c1;
      template_span(p0y - (float)oy0, a.radius, side, r0, r1);
      template_span(p0x - (float)ox0, a.radius, side, c0, c1);
      const bool coarsest = lvl == a.levels - 1;
      if (!coarsest) {
        // every thread is past the coarser level's last reduction barrier:
        // no one reads the target window any more
        fetch_window(tgt, stride, a.cur[lvl], w, oy1, ox1, 0, side - 1, 0, side - 1);
        __pipeline_commit();
      }
      // this level's template window has landed: the groups committed after
      // it are the finer levels' templates and this level's target (which
      // for the coarsest level came with its template)
      __pipeline_wait_prior(a.levels - 1);
      __syncthreads();
      STAMP(clk, kWindows);
      float vx, vy, d2;
      bool ok;
      int trips;
      track_level<NS>(sh, dyn + lvl * template_floats(S), tstride, r0, c0, tgt, !coarsest, side,
                      stride, ox0, oy0, ox1, oy1, p0x, p0y, gx0, gy0, a.radius, a.iters, vx, vy,
                      ok, trips, d2, clk);
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

  // the row's other fields, read only now: kept live through LK they
  // would take registers that its trips need
  float warp[4];
  for (int k = 0; k < 4; ++k) warp[k] = a.warp[4 * p + k];
  float flow = a.flow[p], twu = a.twu[p];
  int noe = a.num_of_events[p];

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
  MARK(clk, kBudget);
  if (tid == 0) {
    a.alive_out[p] = alive;
    a.initialized_out[p] = init;
    for (int k = 0; k < 4; ++k) a.warp_out[4 * p + k] = warp[k];
    a.flow_out[p] = flow;
    a.twu_out[p] = twu;
    a.num_of_events_out[p] = noe;
  }
#ifdef EVO_FR_CLOCKS
  MARK(clk, kWrite);
  if (tid == 0 && a.clocks) {
    clk.bins[kTotal] = clk.last - clk.start;
    for (int k = 0; k < kStages; ++k) a.clocks[kStages * p + k] = clk.bins[k];
  }
#endif
}

// the dynamic shared memory attribute, set once for each instantiation
std::mutex attr_lock;
bool attr_set[kMaxSamples + 1];

template <int NS>
cudaError_t launch_rows(const Args& a, size_t smem, cudaStream_t stream) {
  {
    std::lock_guard<std::mutex> hold(attr_lock);
    if (!attr_set[NS]) {
      const cudaError_t err =
          cudaFuncSetAttribute(frame_rows_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)((kMaxLevels * template_floats(kMaxS) + kWinFloats) *
                                     sizeof(float)));
      if (err != cudaSuccess) return err;
      attr_set[NS] = true;
    }
  }
  void (*kernel)(Args) = frame_rows_kernel<NS>;
  kernel<<<a.P, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One launch over the P rows. `ptrs` holds the Args pointers in their order
// (`kernels/frame_rows.py::POINTERS`); the LK diagnostics and the clocks may
// be null, and the pyramids are read with with_lk only. levels <= 3,
// radius <= kMaxRadius.
extern "C" int evo_frame_rows(const void* const* ptrs, int P, int H, int W, int levels,
                              int radius, int iters, int with_lk, void* stream) {
  if (P == 0) return (int)cudaSuccess;
  if (levels < 1 || levels > kMaxLevels || radius < 0 || radius > kMaxRadius)
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
  // the levels' templates, then the target window (level 0's the largest)
  const int S = 2 * radius + 1, side = min(kLkWin, min(H, W));
  const size_t smem =
      with_lk ? (size_t)(levels * template_floats(S) + side * window_stride(side, S)) * 4 : 0;
  const int ns = (S * S + kThreads - 1) / kThreads;
  static_assert(kMaxSamples == 7, "one instantiation for each count of samples a thread");
  cudaError_t err;
  switch (ns) {
    case 1: err = launch_rows<1>(a, smem, (cudaStream_t)stream); break;
    case 2: err = launch_rows<2>(a, smem, (cudaStream_t)stream); break;
    case 3: err = launch_rows<3>(a, smem, (cudaStream_t)stream); break;
    case 4: err = launch_rows<4>(a, smem, (cudaStream_t)stream); break;
    case 5: err = launch_rows<5>(a, smem, (cudaStream_t)stream); break;
    case 6: err = launch_rows<6>(a, smem, (cudaStream_t)stream); break;
    default: err = launch_rows<7>(a, smem, (cudaStream_t)stream); break;
  }
  return (int)err;
}
