// Contrast compensation's tile residual and its Jacobian, one block per tile
// row, for Hopper (sm_90a).
//
// Replaces `evo_tpu/tracker/compensate.py::tile_residual` (:138) with
// `tile_edge_loss` (:80) or `tile_variance_loss` (:124), taken under
// `jax.jacfwd` with two tangents inside `solve_motion_field` (:207-213):
// XLA device code shaped for the TPU's matrix unit (the Gaussian splat as
// dense tap-matrix contractions, the structure tensor's blur as banded
// Toeplitz matmuls). Its plain PyTorch version is
// `evo_tpu_torch/tracker/compensate.py::tile_residual_and_jacobian_ref`,
// reverse mode through autograd; this file is the JAX package's forward mode,
// with each value carried beside its two tangents (d/d vx, d/d vy) as dual
// numbers.
//
// A row: its events [E] are warped by the row's velocity into the tile's
// 3x-padded frame (px = ((ex + dt * scale * vx) - tlx) + tile, each step
// rounded on its own as the plain version's elementwise operations are, so
// a tap at |d| == radius is inside or outside as there), and splatted as 7x7
// Gaussians into three planes: the image and its tangents, sum w G'(x) G(y) s
// and sum w G(x) G'(y) s with s = dt * scale. Then, in shared memory:
// - `escaped` from the image's mean, summed in one fixed order;
// - the edge loss: forward differences (zero on the last row and column),
//   their three products, the separable 7-tap blur with a zero boundary
//   (the plain version's truncated band, its coefficients passed in), the
//   trace and discriminant, lambda_1, the 5x5 stride-2 max-pool and the sum;
//   the tangents follow the plain version's subgradients: `clamp_min`
//   passes the tangent where its input is at or above its bound, the
//   square root of the clamped discriminant has none below 1e-12, and a
//   pooling window takes the tangent of the element its forward picks (the
//   first largest in row-major order, as PyTorch's CPU max-pool);
// - or the variance loss of the positive pixels, with its tangents.
// r = maxRes - score (or the escape penalty maxRes (1 + |v|^2)), J = dr/dv,
// both 0 where the tile is not active. The tests also read `escaped` and the
// score itself (r, near maxRes, holds it to 6e-5 alone).
//
// What bounds it: latency. A 60x60 tile of 1024 events is about 0.3 MFLOP of
// splat and 1.2 MFLOP of loss, and its bytes are ~13 KB; 108 rows are a few
// microseconds of the card by either count. One block a row keeps the row
// on one SM, in shared memory; nothing but r, J and `escaped` is written
// out. The design:
// - The reach: one pass over the row's events gives the box of their
//   candidate taps in the tile (a block min/max, exact in any order).
// - The splat: private copies of the three planes over the reach only, as
//   many as fit, up to one a warp (16 for a 20 px tile's ~28x28 reach;
//   for a 40 px tile the copies may take the image planes' memory too, 7
//   copies of its ~50x50 reach). Copy c takes the events c, c + copies,
//   ... (not a share of E: padding must not move an event to another
//   copy), and a depositing warp takes them in order, 32 at a time from
//   device memory, and deposits
//   one event at a time with its 8x8 candidate cells spread over the lanes
//   (two cells a lane, no two lanes on an address), each lane taking its
//   own Gaussian taps (a column tap and two row taps): no staging, no
//   block barrier in the event loop, no atomics. With three warps or
//   fewer a copy, each warp deposits one plane, else all three. The copies
//   are summed in order into the image planes.
// - The edge loss, only where the events reach: the image is zero outside
//   the reach, so the blurred structure tensor is zero outside the reach
//   widened by 4 pixels (a difference and a 7-tap blur), and lambda_1 with
//   its tangents is there that of a zero tensor, which those pixels take
//   (the bits the full computation gives them). The vertical pass walks a
//   column segment with the 7 rows of products a tap reaches in registers
//   (each pixel's differences and products taken once, not once a tap),
//   the horizontal pass a row segment with 7 columns of the vertical
//   pass's output, both unrolled by 7 so that a row's slot is a static
//   register index. In strips of pool rows where the tile is larger than
//   shared memory holds (a 40 px tile: 3 pool rows a strip).
// Every sum runs in one fixed order (a copy's events in order, the copies
// in order, a thread's pixels by index, then a fixed tree over the block),
// so a row's bits depend on that row alone, never on the rows launched
// beside it or on the strips, and padding events (valid false) change
// nothing.
//
// Built with -fmad=false, as the alignment kernel is: each product and sum
// rounds on its own, but for three choices within the bars it is held to
// (the score 1e-4 relative, J 1e-3): the Gaussian taps take the card's fast
// exponential `__expf` (a few ulp), the 7-tap blurs' multiply-adds are
// fused (`__fmaf_rn`), and lambda_1's square root and its reciprocal come
// from one `rsqrtf`. Rows whose window is not `live` are left unwritten.
// Nothing here allocates or synchronises with the host.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;         // a block: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int K = 8;                  // candidate taps an axis (radius <= 3)
constexpr int kMaxSide = 120;         // the largest padded tile side taken (40 px tiles)
constexpr int kSumRegs = 16;          // reach values a thread sums in registers
constexpr int kPool = 5, kPoolStep = 2;
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;      // 227 KB a block, static and dynamic
constexpr int kDynSmem = kMaxSmem - 1024;  // the dynamic part: 1 KB left for the reach
constexpr int kEdge = 0, kVariance = 1;
constexpr float kMaxRes = 1e3f;

// The pointer array of the C entry, in this order.
struct Args {
  const float* vel;             // [R, 2]
  const float* ex;              // [R, E]
  const float* ey;              // [R, E]
  const float* dt;              // [R, E] t_mid - t_event, microseconds
  const unsigned char* valid;   // [R, E]
  const float* tlx;             // [R]
  const float* tly;             // [R]
  const unsigned char* active;  // [R]
  const int* live;              // [R / rows_per_window] or null: every row
  float* r;                     // [R]
  float* J;                     // [R, 2]
  unsigned char* escaped;       // [R] or null
  float* score;                 // [R] or null: the loss, 0 where none is taken
  long long* clocks;            // [R, kStages] or null (the clock build only)
};

struct Shape {
  int E, side, rows_per_window, total_floats, loss, strip;
  float scale, tile, weight, inv_sigma, radius;
  float blur[4];  // the blur's taps at distance 0..3
};

// Stage clock (built with -DEVO_COMP_CLOCKS only): thread 0 adds the
// clock64() cycles since the previous mark into a stage's bin. MARK comes
// after a barrier of its own, so a stage's time is its slowest thread's; the
// stages add up to the total. The plain build has neither marks nor barriers.
enum Stage { kReach, kZero, kDeposit, kCopies, kEscaped, kVertical, kHorizontal, kPooling,
             kReduce, kTotal, kStages };
struct Clock {
  long long last, start, bins[kStages];
};
#ifdef EVO_COMP_CLOCKS
__device__ void stamp(Clock& clk, int stage) {
  if (threadIdx.x == 0) {
    const long long t = clock64();
    clk.bins[stage] += t - clk.last;
    clk.last = t;
  }
}
__device__ void clock_start(Clock& clk) {
  if (threadIdx.x == 0) {
    clk.start = clk.last = clock64();
    for (int k = 0; k < kStages; ++k) clk.bins[k] = 0;
  }
}
__device__ void clock_out(Clock& clk, long long* out) {
  if (threadIdx.x == 0 && out != nullptr) {
    clk.bins[kTotal] = clk.last - clk.start;
    for (int k = 0; k < kStages; ++k) out[k] = clk.bins[k];
  }
}
#define MARK(stage) (__syncthreads(), stamp(clk, stage))
#define CLOCK_START() clock_start(clk)
#define CLOCK_OUT(row) clock_out(clk, a.clocks ? a.clocks + (size_t)(row) * kStages : nullptr)
#else
#define MARK(stage) ((void)0)
#define CLOCK_START() ((void)0)
#define CLOCK_OUT(row) ((void)0)
#endif

// The Gaussian tap at d = grid - coordinate and its derivative with respect
// to the coordinate, zero beyond the radius (`kernels.splat._taps`).
__device__ __forceinline__ void gauss_tap(float d, float inv_sigma, float radius,
                                          float* k, float* dk) {
  // taken in every lane and selected (no branch around the exponential)
  const float q = d * inv_sigma;
  const float g = __expf(-0.5f * q * q);
  const bool in = fabsf(d) <= radius;
  *k = in ? g : 0.0f;
  *dk = in ? (g * q) * inv_sigma : 0.0f;
}

// First of the K candidate grid lines of an event at c (`csrc/splat.cu`).
__device__ __forceinline__ int tap_base(float c) {
  return (int)floorf(fminf(fmaxf(c, -16.0f), 16777216.0f)) - (K / 2 - 1);
}

// Sums v[0..N) over the block in one fixed order (a tree over the threads);
// every thread gets the sums. `red` holds N * kThreads floats.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  const int tid = threadIdx.x;
  for (int n = 0; n < N; ++n) red[n * kThreads + tid] = v[n];
  __syncthreads();
  for (int st = kThreads / 2; st > 0; st >>= 1) {
    if (tid < st)
      for (int n = 0; n < N; ++n) red[n * kThreads + tid] += red[n * kThreads + tid + st];
    __syncthreads();
  }
  for (int n = 0; n < N; ++n) v[n] = red[n * kThreads];
  __syncthreads();
}

// A valid event's warped position (px, py) in the padded tile, its time
// factor sh = dt * scale and its candidate taps' first lines (x0, y0);
// false for padding, a position that is not finite, or taps all outside.
__device__ __forceinline__ bool event_at(const Args& a, const Shape& s, size_t g, float vx,
                                         float vy, float ox, float oy, float* px, float* py,
                                         float* sh, int* x0, int* y0) {
  if (!a.valid[g]) return false;  // padding: weight 0 adds nothing
  *sh = a.dt[g] * s.scale;
  *px = ((a.ex[g] + *sh * vx) - ox) + s.tile;
  *py = ((a.ey[g] + *sh * vy) - oy) + s.tile;
  if (!isfinite(*px) || !isfinite(*py)) return false;
  *x0 = tap_base(*px);
  *y0 = tap_base(*py);
  return !(*y0 + K <= 0 || *y0 >= s.side || *x0 + K <= 0 || *x0 >= s.side);
}

// The nine products of the forward differences at (hh, w): gx gx, gx gy,
// gy gy, then their tangents along vx and along vy; zero on the last row
// and column and outside the image.
__device__ __forceinline__ void products(const float* I, const float* Ia, const float* Ib,
                                         int side, int hh, int w, float* P) {
  if (hh < 0 || hh >= side - 1 || w >= side - 1) {
    for (int c = 0; c < 9; ++c) P[c] = 0.0f;
    return;
  }
  const int q = hh * side + w;
  const float gx = I[q + 1] - I[q], gy = I[q + side] - I[q];
  const float gxa = Ia[q + 1] - Ia[q], gya = Ia[q + side] - Ia[q];
  const float gxb = Ib[q + 1] - Ib[q], gyb = Ib[q + side] - Ib[q];
  P[0] = gx * gx;
  P[1] = gx * gy;
  P[2] = gy * gy;
  P[3] = gxa * gx + gx * gxa;
  P[4] = gxa * gy + gx * gya;
  P[5] = gya * gy + gy * gya;
  P[6] = gxb * gx + gx * gxb;
  P[7] = gxb * gy + gx * gyb;
  P[8] = gyb * gy + gy * gyb;
}

// The products blurred along the columns into V [9][rows][side] (a strip
// of the image from row h0), for the strip rows [r0, r1) and the columns
// [c0, c1). Thread (segment, column) walks its segment's rows with the
// products of the 7 rows a tap reaches in registers (a row's products are
// taken once, not once a tap): the loop is unrolled by 7, so a row's slot
// is a static index. Each output adds its taps from the top.
__device__ void vertical_pass(const float* I, const float* Ia, const float* Ib, float* V,
                              int SP, int side, int h0, int r0, int r1, int c0, int c1,
                              const float* blur) {
  const int width = c1 - c0, nrows = r1 - r0;
  if (width <= 0 || nrows <= 0) return;
  const int nseg = max(1, min(kThreads / width, nrows / 4));
  const int len = (nrows + nseg - 1) / nseg;
  const int w = c0 + threadIdx.x % width, seg = threadIdx.x / width;
  if (seg >= nseg) return;
  const int hs = r0 + seg * len, he = min(r1, hs + len);
  float P[7][9];
  for (int b = hs - 3; b < he + 3; b += 7) {
#pragma unroll
    for (int u = 0; u < 7; ++u) {
      const int rr = b + u;  // the strip row whose products enter slot u
      if (rr >= he + 3) break;
      products(I, Ia, Ib, side, h0 + rr, w, P[u]);
      const int o = rr - 3;  // the output row whose last tap is rr
      if (o < hs) continue;
      float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = -3; k <= 3; ++k) {
        const float g = blur[k < 0 ? -k : k];
        const float* Pk = P[(u + 4 + k) % 7];  // row o + k
#pragma unroll
        for (int c = 0; c < 9; ++c) acc[c] = __fmaf_rn(g, Pk[c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < 9; ++c) V[c * SP + o * side + w] = acc[c];
    }
  }
}

// lambda_1 of the blurred structure tensor S (its three entries, then their
// tangents along vx and vy) and its tangents: lam[0] the value, lam[1],
// lam[2] the tangents, with the plain version's subgradients.
__device__ __forceinline__ void lambda1(const float* S, float* lam) {
  const float sxx = S[0], sxy = S[1], syy = S[2];
  const float tr = sxx + syy, dd = sxx - syy;
  const float disc2 = dd * dd + 4.0f * sxy * sxy;
  const bool dpass = disc2 >= 1e-12f;
  // the square root and its reciprocal from one reciprocal square root of
  // a normal number (within a few ulp of the quotient and the root)
  const float clamped = disc2 < 1e-12f ? 1e-12f : disc2;
  const float rs = rsqrtf(clamped);
  const float disc = clamped * rs;
  const float half_inv = 0.5f * rs;
  const float u = 0.5f * (tr + disc);
  const bool upass = u >= 0.0f;
  lam[0] = u < 0.0f ? 0.0f : u;
  for (int t = 1; t < 3; ++t) {
    const float txx = S[3 * t], txy = S[3 * t + 1], tyy = S[3 * t + 2];
    const float tdd = txx - tyy;
    const float tdisc2 = 2.0f * dd * tdd + 8.0f * sxy * txy;
    const float tdisc = dpass ? tdisc2 * half_inv : 0.0f;
    lam[t] = upass ? 0.5f * ((txx + tyy) + tdisc) : 0.0f;
  }
}

// V blurred along the rows, then lambda_1 and its tangents into L
// [3][rows][side], for the strip rows [r0, r1) and the columns [c0, c1),
// reading V as zero outside its columns [v0, v1): thread (segment, row)
// walks its segment's columns with the 7 columns a tap reaches in
// registers, as `vertical_pass` walks rows. The strip's other pixels
// (`nrows` rows) take `empty`, lambda_1 and its tangents where the blurred
// structure tensor is zero.
__device__ void horizontal_pass(const float* V, float* L, int SP, int side, int nrows, int r0,
                                int r1, int c0, int c1, int v0, int v1, const float* empty,
                                const float* blur) {
  for (int i = threadIdx.x; i < nrows * side; i += kThreads) {
    const int h = i / side, w = i % side;
    if (h >= r0 && h < r1 && w >= c0 && w < c1) continue;
    L[i] = empty[0];
    L[SP + i] = empty[1];
    L[2 * SP + i] = empty[2];
  }
  const int rows = r1 - r0, width = c1 - c0;
  if (rows <= 0 || width <= 0) return;
  const int nseg = max(1, min(kThreads / rows, width / 4));
  const int len = (width + nseg - 1) / nseg;
  const int h = r0 + threadIdx.x % rows, seg = threadIdx.x / rows;
  if (seg >= nseg) return;
  const int ws = c0 + seg * len, we = min(c1, ws + len);
  const float* Vh = V + h * side;
  float Q[7][9];
  for (int b = ws - 3; b < we + 3; b += 7) {
#pragma unroll
    for (int u = 0; u < 7; ++u) {
      const int c = b + u;  // the column that enters slot u
      if (c >= we + 3) break;
#pragma unroll
      for (int ch = 0; ch < 9; ++ch) Q[u][ch] = c >= v0 && c < v1 ? Vh[ch * SP + c] : 0.0f;
      const int o = c - 3;
      if (o < ws) continue;
      float S[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k = -3; k <= 3; ++k) {
        const float g = blur[k < 0 ? -k : k];
        const float* Qk = Q[(u + 4 + k) % 7];  // column o + k
#pragma unroll
        for (int ch = 0; ch < 9; ++ch) S[ch] = __fmaf_rn(g, Qk[ch], S[ch]);
      }
      float lam[3];
      lambda1(S, lam);
      L[h * side + o] = lam[0];
      L[SP + h * side + o] = lam[1];
      L[2 * SP + h * side + o] = lam[2];
    }
  }
}

// One warp's deposits of the events first, first + step, ... below E of the
// row at `base`, in order, into its copy `at` (pixel (y, x) of plane p at at[p * pstride + y *
// ystride + x]): all three planes (kAll) or plane `plane` alone. Lane (i0,
// j0) takes the stamp's cells (i0, j0) and (i0 + 4, j0) of each event, its
// taps computed in the lane (a column tap and two row taps), and skips a
// cell outside the radius or the tile (it would add 0).
template <bool kAll>
__device__ void deposit(const Args& a, const Shape& s, size_t base, float vx, float vy,
                        float ox, float oy, float* at, int ystride, int pstride, int plane,
                        int first, int step) {
  const int lane = threadIdx.x % 32, i0 = lane / K, j0 = lane % K;
  const float w = s.weight;
  for (int e0 = first; e0 < s.E; e0 += 32 * step) {
    float px = 0.0f, py = 0.0f, sh = 0.0f;
    int x0, y0;
    const int e = e0 + lane * step;
    const bool live = e < s.E &&
                      event_at(a, s, base + e, vx, vy, ox, oy, &px, &py, &sh, &x0, &y0);
    for (unsigned m = __ballot_sync(kFull, live); m != 0; m &= m - 1) {
      const int k = __ffs(m) - 1;  // the next live event, in order
      const float qx = __shfl_sync(kFull, px, k), qy = __shfl_sync(kFull, py, k);
      const float ws = w * __shfl_sync(kFull, sh, k);
      const int c = tap_base(qx) + j0, by = tap_base(qy);
      float kx, dkx;
      gauss_tap((float)c - qx, s.inv_sigma, s.radius, &kx, &dkx);
      // each cell's offset (-1: nothing to add) and what each plane adds
      // there; all loads before any store: the compiler cannot tell the
      // addresses apart and would wait on each store
      int off0, off1;
      float a00, a01, a02, a10, a11, a12;
      {
        const int h = by + i0;
        float ky, dky;
        gauss_tap((float)h - qy, s.inv_sigma, s.radius, &ky, &dky);
        off0 = h >= 0 && h < s.side && c >= 0 && c < s.side && kx != 0.0f && ky != 0.0f
                   ? h * ystride + c : -1;
        a00 = (w * ky) * kx;
        a01 = (ws * ky) * dkx;
        a02 = (ws * dky) * kx;
      }
      {
        const int h = by + i0 + 4;
        float ky, dky;
        gauss_tap((float)h - qy, s.inv_sigma, s.radius, &ky, &dky);
        off1 = h >= 0 && h < s.side && c >= 0 && c < s.side && kx != 0.0f && ky != 0.0f
                   ? h * ystride + c : -1;
        a10 = (w * ky) * kx;
        a11 = (ws * ky) * dkx;
        a12 = (ws * dky) * kx;
      }
      if (kAll) {
        float* p0 = at + off0;
        float* p1 = at + off1;
        const float c00 = off0 >= 0 ? p0[0] : 0.0f, c01 = off0 >= 0 ? p0[pstride] : 0.0f;
        const float c02 = off0 >= 0 ? p0[2 * pstride] : 0.0f;
        const float c10 = off1 >= 0 ? p1[0] : 0.0f, c11 = off1 >= 0 ? p1[pstride] : 0.0f;
        const float c12 = off1 >= 0 ? p1[2 * pstride] : 0.0f;
        if (off0 >= 0) {
          p0[0] = c00 + a00;
          p0[pstride] = c01 + a01;
          p0[2 * pstride] = c02 + a02;
        }
        if (off1 >= 0) {
          p1[0] = c10 + a10;
          p1[pstride] = c11 + a11;
          p1[2 * pstride] = c12 + a12;
        }
      } else {
        float* mine = at + plane * pstride;
        const float add0 = plane == 0 ? a00 : plane == 1 ? a01 : a02;
        const float add1 = plane == 0 ? a10 : plane == 1 ? a11 : a12;
        const float c0 = off0 >= 0 ? mine[off0] : 0.0f, c1 = off1 >= 0 ? mine[off1] : 0.0f;
        if (off0 >= 0) mine[off0] = c0 + add0;
        if (off1 >= 0) mine[off1] = c1 + add1;
      }
      __syncwarp();  // the next event may touch these pixels from other lanes
    }
  }
}

__global__ void __launch_bounds__(kThreads) comp_tile_kernel(Args a, Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x;
  if (a.live != nullptr && a.live[row / s.rows_per_window] == 0) return;
  Clock clk;
  (void)clk;
  CLOCK_START();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int side = s.side, HW = side * side;
  float* planes = smem;  // the image I and its tangents Ia, Ib: [3][side][side]
  // the reductions' scratch, past the image and its tangents once the
  // copies are summed
  float* red = smem + 3 * HW;
  const float vx = a.vel[2 * row], vy = a.vel[2 * row + 1];
  const float ox = a.tlx[row], oy = a.tly[row];
  const size_t base = (size_t)row * s.E;

  // ---- the row's reach: the box of its events' candidate taps in the tile
  __shared__ int reach_part[kThreads / 32][4];
  int reach[4] = {side, 0, side, 0};  // y from, y to, x from, x to
  for (int e = tid; e < s.E; e += kThreads) {
    float px, py, sh;
    int x0, y0;
    if (event_at(a, s, base + e, vx, vy, ox, oy, &px, &py, &sh, &x0, &y0)) {
      reach[0] = min(reach[0], max(y0, 0));
      reach[1] = max(reach[1], min(y0 + K, side));
      reach[2] = min(reach[2], max(x0, 0));
      reach[3] = max(reach[3], min(x0 + K, side));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    reach[0] = min(reach[0], __shfl_xor_sync(kFull, reach[0], o));
    reach[1] = max(reach[1], __shfl_xor_sync(kFull, reach[1], o));
    reach[2] = min(reach[2], __shfl_xor_sync(kFull, reach[2], o));
    reach[3] = max(reach[3], __shfl_xor_sync(kFull, reach[3], o));
  }
  if (lane == 0)
    for (int k = 0; k < 4; ++k) reach_part[warp][k] = reach[k];
  for (int i = tid; i < 3 * HW; i += kThreads) planes[i] = 0.0f;
  __syncthreads();
  for (int w = 0; w < kThreads / 32; ++w) {
    reach[0] = min(reach[0], reach_part[w][0]);
    reach[1] = max(reach[1], reach_part[w][1]);
    reach[2] = min(reach[2], reach_part[w][2]);
    reach[3] = max(reach[3], reach_part[w][3]);
  }
  MARK(kReach);
  // private copies of the three planes over the reach, [3][rh][rw] each,
  // as many as fit (at most kWarps): copy 0 is the image planes themselves
  // and the others lie past them; or, where that gives more copies and a
  // thread can sum its share of the reach in registers, they take the whole
  // of shared memory, the image planes included (`pooled`: the 40 px tiles,
  // whose image planes take three quarters of it). Depositing warp w takes copy w / split,
  // its planes (all three, or plane w % 3 when split is 3), and its copy's
  // events c, c + copies, ... in order.
  const int ry = reach[0], rx = reach[2];
  const int rh = max(reach[1] - ry, 0), rw = max(reach[3] - rx, 0), rsize = 3 * rh * rw;
  const int beside = rsize == 0 ? 1 : 1 + min((s.total_floats - 3 * HW) / rsize, kWarps - 1);
  const int anywhere = rsize == 0 ? 1 : min(s.total_floats / rsize, kWarps);
  const bool pooled = rsize > 0 && rsize <= kSumRegs * kThreads && anywhere > beside;
  const int copies = pooled ? anywhere : beside;
  float* extra = pooled ? planes : planes + 3 * HW;  // copy 1 (pooled: copy 0)
  const int split = 3 * copies <= kWarps ? 3 : 1;
  for (int i = tid; i < (pooled ? copies : copies - 1) * rsize; i += kThreads) extra[i] = 0.0f;
  __syncthreads();
  MARK(kZero);
  if (warp < copies * split && rsize > 0) {
    const int copy = warp / split;
    // pixel (y, x) of plane p of the copy: at[p * pstride + y * ystride + x]
    const bool image = copy == 0 && !pooled;
    float* at = image ? planes : extra + (pooled ? copy : copy - 1) * rsize - ry * rw - rx;
    const int ystride = image ? side : rw, pstride = image ? HW : rh * rw;
    if (split == 1)
      deposit<true>(a, s, base, vx, vy, ox, oy, at, ystride, pstride, 0, copy, copies);
    else
      deposit<false>(a, s, base, vx, vy, ox, oy, at, ystride, pstride, warp % 3, copy, copies);
  }
  __syncthreads();
  MARK(kDeposit);
  // the copies summed in order into the image I and its tangents, over the
  // reach (pooled: through registers, then the image planes zeroed and
  // written, as the copies lay on them)
  if (pooled) {
    float acc[kSumRegs];
#pragma unroll
    for (int k = 0; k < kSumRegs; ++k) {
      const int i = tid + k * kThreads;
      acc[k] = 0.0f;
      if (i < rsize) {
        acc[k] = extra[i];
        for (int c = 1; c < copies; ++c) acc[k] += extra[c * rsize + i];
      }
    }
    __syncthreads();
    for (int i = tid; i < 3 * HW; i += kThreads) planes[i] = 0.0f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSumRegs; ++k) {
      const int i = tid + k * kThreads;
      if (i < rsize) {
        const int p = i / (rh * rw), q = i % (rh * rw);
        planes[p * HW + (ry + q / rw) * side + rx + q % rw] = acc[k];
      }
    }
  } else {
    for (int i = tid; i < rsize; i += kThreads) {
      const int p = i / (rh * rw), q = i % (rh * rw);
      const int y = ry + q / rw, x = rx + q % rw;
      float acc = planes[p * HW + y * side + x];
#pragma unroll 4
      for (int c = 1; c < copies; ++c) acc += extra[(c - 1) * rsize + i];
      planes[p * HW + y * side + x] = acc;
    }
  }
  __syncthreads();
  MARK(kCopies);
  const float* I = planes;
  const float* Ia = planes + HW;
  const float* Ib = planes + 2 * HW;

  // ---- escaped: the image's mean at or below 1e-4
  {
    float m[1] = {0.0f};
    for (int i = tid; i < HW; i += kThreads) m[0] += I[i];
    block_sum<1>(m, red);
    MARK(kEscaped);
    const bool escaped = m[0] / (float)HW <= 1e-4f;
    if (tid == 0 && a.escaped != nullptr) a.escaped[row] = escaped ? 1 : 0;
    if (!a.active[row] || escaped) {
      if (tid == 0) {
        float r = 0.0f, ja = 0.0f, jb = 0.0f;
        if (a.active[row]) {
          r = kMaxRes * ((1.0f + vx * vx) + vy * vy);
          ja = kMaxRes * vx + kMaxRes * vx;
          jb = kMaxRes * vy + kMaxRes * vy;
        }
        a.r[row] = r;
        a.J[2 * row] = ja;
        a.J[2 * row + 1] = jb;
        if (a.score != nullptr) a.score[row] = 0.0f;
      }
      CLOCK_OUT(row);
      return;
    }
  }

  float score, score_a, score_b;
  if (s.loss == kVariance) {
    // the positive pixels' variance, the counter seeded at 1
    float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // count, sum I, sum I_a, sum I_b
    for (int i = tid; i < HW; i += kThreads)
      if (I[i] > 0.0f) {
        m[0] += 1.0f;
        m[1] += I[i];
        m[2] += Ia[i];
        m[3] += Ib[i];
      }
    block_sum<4>(m, red);
    const float cnt = m[0] + 1.0f;
    const float mean = m[1] / cnt, mean_a = m[2] / cnt, mean_b = m[3] / cnt;
    float v[3] = {0.0f, 0.0f, 0.0f};
    for (int i = tid; i < HW; i += kThreads)
      if (I[i] > 0.0f) {
        const float dv = I[i] - mean;
        v[0] += dv * dv;
        v[1] += 2.0f * dv * (Ia[i] - mean_a);
        v[2] += 2.0f * dv * (Ib[i] - mean_b);
      }
    block_sum<3>(v, red);
    const bool pos = mean > 0.0f;
    score = pos ? v[0] / cnt : 0.0f;
    score_a = pos ? v[1] / cnt : 0.0f;
    score_b = pos ? v[2] / cnt : 0.0f;
    MARK(kReduce);
  } else {
    // the loss in strips of pool rows: the pool outputs of rows [o0, o1)
    // read lambda_1 on the image rows [2 o0, 2 o1 + 3), which need the
    // blurred products of those rows, whose vertical taps reach 3 rows up
    // and down and whose differences 1 row down; a strip's nine blurred
    // products V and lambda_1 with its tangents L hold its rows alone (one
    // strip for a 60x60 tile, 3 pool rows a strip for 120x120)
    const int np = (side - kPool) / kPoolStep + 1;
    const int SP = (kPoolStep * (s.strip - 1) + kPool) * side;  // a strip plane
    float* V = planes + 3 * HW;
    float* L = V + 9 * SP;
    float m[3] = {0.0f, 0.0f, 0.0f};
    // where the loss can see the events: the image is zero outside the
    // reach, so the differences' products are zero outside the product
    // box (the reach and one row and column before it, without the last
    // row and column), their vertical blur outside its rows widened by 3,
    // the blurred structure tensor outside its columns widened by 3. Out
    // there lambda_1 and its tangents are those of a zero tensor, `empty`
    // (the bits the full computation gives), and only the box is computed.
    const int pr0 = max(ry - 1, 0), pr1 = min(ry + rh, side - 1);
    const int pc0 = max(rx - 1, 0), pc1 = min(rx + rw, side - 1);
    const int dr0 = max(pr0 - 3, 0), dr1 = min(pr1 + 3, side);
    const int dc0 = max(pc0 - 3, 0), dc1 = min(pc1 + 3, side);
    float empty[3];
    {
      const float zero[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      lambda1(zero, empty);
    }
    for (int o0 = 0; o0 < np; o0 += s.strip) {
      const int o1 = min(o0 + s.strip, np);
      const int h0 = kPoolStep * o0, n = (kPoolStep * (o1 - 1) + kPool - h0) * side;
      // the strip's rows in the box, strip-relative
      const int a0 = max(dr0 - h0, 0), a1 = min(dr1 - h0, n / side);
      // vertical pass: the nine products (gx gx, gx gy, gy gy and their
      // tangents along vx, then vy) blurred along the columns
      vertical_pass(I, Ia, Ib, V, SP, side, h0, a0, a1, pc0, pc1, s.blur);
      __syncthreads();
      MARK(kVertical);
      // horizontal pass, then lambda_1 and its tangents
      horizontal_pass(V, L, SP, side, n / side, a0, a1, dc0, dc1, pc0, pc1, empty, s.blur);
      __syncthreads();
      MARK(kHorizontal);
      // the strip's 5x5 stride-2 max-pool outputs, then their sum: a thread
      // takes the outputs o = tid mod kThreads, so that it adds its outputs
      // in ascending order whatever the strips (the next strip's first
      // write to L follows a barrier)
      const int first = o0 * np, last = o1 * np;
      for (int o = first + ((tid - first) % kThreads + kThreads) % kThreads; o < last;
           o += kThreads) {
        const int y0 = (o / np) * kPoolStep - h0, x0 = (o % np) * kPoolStep;
        float best = -INFINITY;
        int at = y0 * side + x0;
        for (int dy = 0; dy < kPool; ++dy)
          for (int dx = 0; dx < kPool; ++dx) {
            const int q = (y0 + dy) * side + x0 + dx;
            const float val = L[q];
            if (val > best || isnan(val)) {
              best = val;
              at = q;
            }
          }
        const bool keep = best >= 0.0f;
        m[0] += best < 0.0f ? 0.0f : best;
        m[1] += keep ? L[SP + at] : 0.0f;
        m[2] += keep ? L[2 * SP + at] : 0.0f;
      }
      MARK(kPooling);
    }
    // `red` lies on V, last read before the pool's barrier
    block_sum<3>(m, red);
    MARK(kReduce);
    score = m[0] / kMaxRes;
    score_a = m[1] / kMaxRes;
    score_b = m[2] / kMaxRes;
  }
  if (tid == 0) {
    a.r[row] = kMaxRes - score;
    a.J[2 * row] = -score_a;
    a.J[2 * row + 1] = -score_b;
    if (a.score != nullptr) a.score[row] = score;
  }
  CLOCK_OUT(row);
}

// Dynamic shared memory above 48 KB has to be allowed once per device.
cudaError_t allow_smem(size_t bytes) {
  static bool allowed[64];
  if (bytes <= (size_t)kStaticSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(comp_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDynSmem);
  if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  return err;
}

}  // namespace

// The C interface loaded with ctypes; returns the CUDA error of the launch
// (0 = success). `ptrs` holds the device pointers of `Args`, in its order.
// R rows of E events into side x side padded tiles (side <= 120); `live`
// indexes windows of `rows_per_window` rows; loss 0 = edge, 1 = variance;
// b0..b3 the blur's taps at distance 0..3.
extern "C" int evo_comp_tile(const void* const* ptrs, int R, int E, int side,
                             int rows_per_window, int loss, float scale, float tile,
                             float weight, float sigma, float radius, float b0, float b1,
                             float b2, float b3, void* stream) {
  if (R == 0) return (int)cudaSuccess;
  if (side < kPool || side > kMaxSide || E < 0 || rows_per_window < 1
      || (loss != kEdge && loss != kVariance) || !(radius > 0.0f && radius <= 3.0f))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.vel = (const float*)ptrs[0];
  a.ex = (const float*)ptrs[1];
  a.ey = (const float*)ptrs[2];
  a.dt = (const float*)ptrs[3];
  a.valid = (const unsigned char*)ptrs[4];
  a.tlx = (const float*)ptrs[5];
  a.tly = (const float*)ptrs[6];
  a.active = (const unsigned char*)ptrs[7];
  a.live = (const int*)ptrs[8];
  a.r = (float*)ptrs[9];
  a.J = (float*)ptrs[10];
  a.escaped = (unsigned char*)ptrs[11];
  a.score = (float*)ptrs[12];
  a.clocks = (long long*)ptrs[13];
  const int HW = side * side;
  // the image and its tangents (copy 0 of the splat) first; the splat's
  // further copies, sized by each row's reach, then the loss's strips
  // (twelve planes of a strip's rows: as many pool rows as fit) and the
  // reductions' scratch take the memory past it
  const int total = kDynSmem / (int)sizeof(float);
  const int np = (side - kPool) / kPoolStep + 1;
  int strip = ((total - 3 * HW) / (12 * side) - kPool + kPoolStep) / kPoolStep;
  if (strip > np) strip = np;
  if (strip < 1 || total - 3 * HW < 4 * kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)total;
  Shape s;
  s.E = E;
  s.side = side;
  s.rows_per_window = rows_per_window;
  s.total_floats = total;
  s.strip = strip;
  s.loss = loss;
  s.scale = scale;
  s.tile = tile;
  s.weight = weight;
  s.inv_sigma = 1.0f / sigma;
  s.radius = radius;
  s.blur[0] = b0;
  s.blur[1] = b1;
  s.blur[2] = b2;
  s.blur[3] = b3;
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  comp_tile_kernel<<<R, kThreads, smem, (cudaStream_t)stream>>>(a, s);
  return (int)cudaGetLastError();
}
