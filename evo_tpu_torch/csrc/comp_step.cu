// Contrast compensation's LM step over a window's tile velocities, one block
// of four warps per window, for Hopper (sm_90a).
//
// Replaces `evo_tpu/tracker/compensate.py::solve_motion_field`'s `step`
// (:227-288) inside its `jax.lax.while_loop` (:290): the assembly of the
// damped 2T x 2T normal system over the per-tile 2x2 blocks and the TV grid
// edges (IRLS Huber weights), its dense Cholesky solve (`cho_factor` /
// `cho_solve`), the accept test, the damping update and the stop. XLA
// device code, not Pallas. Its plain PyTorch versions are
// `evo_tpu_torch/tracker/compensate.py::tile_system` (the solve) and
// `lm_head` / `lm_tail` (the loop's lines around it).
//
// Two entries over shared device functions:
// - `evo_comp_solve(jj, jr, w2, d, lam) -> (delta, ok)`: `tile_system`'s
//   solve, which the space-sharded solve's root calls;
// - `evo_comp_lm_step`: the unmeshed loop's tail of iteration k (cost of the
//   candidate from the residuals kernel A wrote at it, accept, damping,
//   stop) folded with the head of iteration k + 1 (TV differences, IRLS
//   weights, the solve, the next candidate), each part by a flag; the first
//   launch computes the initial cost instead of a tail. A window that has
//   stopped returns at once, so the host may queue trips past the stop.
//
// The system is banded: with the tiles in row-major order a TV edge joins
// tiles at most tx apart, so every entry lies within 2 tx of the diagonal
// (24 for 12 columns), the 2x2 tile blocks too. A holds the lower band only
// (216 x 28 floats for 108 tiles, against 216^2), is factored by a banded
// Cholesky without pivoting and solved by forward and back substitution.
// `ok` is what `torch.linalg.cholesky_ex`'s `info == 0` says (LAPACK's
// test): every pivot positive and not NaN.
//
// What bounds it: latency. The factorisation is 2T pivots in series, each a
// square root, a reciprocal, a column scaled and a band-sized rank-1 update;
// the operations (~2T * band^2) are a fraction of a microsecond of the card.
// So the pivot chain runs in one warp's registers, with no block barrier
// and no index table (spread over the block's four warps it would take two
// barriers a pivot and a table of the update's entries): the band + 1 rows of the active window lie one a lane (row r in lane r mod
// (band + 1)), row r's entry in column c in its register c mod 2 (band + 1).
// The pivot loop is unrolled by 2 (band + 1), so the pivot's column is a
// static register index. A pivot is: its column scaled in place and put in
// shared memory (a store a lane, then vector loads of the same addresses,
// one broadcast each); the update of the next row, then the next pivot's
// diagonal by one shuffle and its reciprocal square root, taken one pivot
// ahead so that it runs beside this pivot's other updates; then every lane
// past the pivot updates its row from the column, with no test of its row:
// the registers hold twice the band, so an update of a column past the row
// lands in a spare register. The row that leaves goes to shared memory (in
// 16-byte pieces, rows padded to a multiple of 4 floats); the row that
// enters in the pivot's lane is read ahead into the leaving row's spare
// registers. The back substitution runs from the bottom in the same
// rotating layout, one shuffle a row, its next row's entries read a row
// ahead and no branch on the lane. This register design is built for the
// bands of the main path's grids (24 for the 12 x 9 grid of 20 px tiles, 12
// for the 6 x 4 grid of 40 px tiles); any other band up to 64 (the scaling
// measurement's 16-column grid of 15 px tiles: 32, whose 33 rows a warp
// cannot hold) takes a block-wide factorisation (`factor_and_solve_block`). The other three warps of the block assemble
// the system and then wait. The windows run side by side, one block each. Every sum runs in one fixed order (a
// lane's terms by index, then a fixed shuffle tree; each entry's updates by
// pivot), so a window's bits depend on its own inputs alone.
//
// Built with -fmad=false, so that the costs, weights and assembly round as
// the plain version's elementwise operations do. Both factorisations take
// the same products and differences in the same order; the register one
// takes each pivot's 1 / L(j, j) as the card's `rsqrtf` of the pivot
// (within 2 ulp of IEEE's 1 / sqrtf, which the block-wide one takes), well
// inside the backward-error bar of 1e-6 the solve is held to. Nothing here allocates
// or synchronises with the host.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;
constexpr int kThreads = 128;  // a block: 4 warps a window
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInit = 1, kTail = 2, kHead = 4;
constexpr int kMaxBand = 64;
constexpr int kBatch = 4;  // entries of the block-wide update a thread loads at once

// A row of the band in shared memory: band + 1 floats padded to a multiple
// of 4, so that a row moves as 16-byte pieces.
__host__ __device__ inline int row_floats(int band) { return (band + 4) / 4 * 4; }

// Stage clock (built with -DEVO_COMP_CLOCKS only): thread 0 adds the
// clock64() cycles since the previous mark into a stage's bin. MARK comes
// after a barrier of its own, so a stage's time is its slowest thread's;
// STAMP has no barrier, for the marks inside warp 0's factorisation (each
// pivot's square root and first update, the column's broadcast, the rest of
// the update, the rows' exchange). The stages add up to the total. The
// plain build has neither marks nor barriers.
enum Stage { kInitCost, kTailCost, kWeights, kAssemble, kPivot, kColumn, kUpdate, kExchange,
             kBack, kCandidate, kTotal, kStages };
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
#define STAMP(stage) stamp(clk, stage)
#define CLOCK_START() clock_start(clk)
#define CLOCK_OUT(out) clock_out(clk, out)
#else
#define MARK(stage) ((void)0)
#define STAMP(stage) ((void)0)
#define CLOCK_START() ((void)0)
#define CLOCK_OUT(out) ((void)0)
#endif

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Where a window's band, right-hand side, edge weights and differences and
// the block's flags lie in shared memory.
struct Work {
  float* A;    // [n][row_floats(band)]: A[i][k] = A(i, i - k), k <= band
  float* col;  // [2][32]: the pivot's column of L, for its warp (two in turn)
  float* x;    // [n]: b, then the solution
  float* inv;  // [n]: 1 / L(i, i)
  float* w2;   // [E]
  float* d;    // [E][2]
  int* flag;   // [4]: what one thread tells the block
  int* pairs;  // [band (band + 1) / 2]: (i' << 16) | k', 1 <= k' <= i' <= band
};

__device__ __forceinline__ Work carve(float* smem, int n, int E, int band) {
  Work w;
  w.A = smem;
  w.col = w.A + n * row_floats(band);
  w.x = w.col + 64;
  w.inv = w.x + n;
  w.w2 = w.inv + n;
  w.d = w.w2 + E;
  w.flag = reinterpret_cast<int*>(w.d + 2 * E);
  w.pairs = w.flag + 4;
  return w;
}

__host__ __device__ inline size_t work_bytes(int n, int E, int band) {
  return sizeof(float) * ((size_t)n * (row_floats(band) + 2) + 64 + 3 * (size_t)E)
         + sizeof(int) * (size_t)(4 + band * (band + 1) / 2);
}

// The edges at each tile (`kernels.comp_step.incidence`, built once per
// edge list): start [T + 1] and, for tile t, inc[start[t] .. start[t + 1])
// as 2 e + role, the edges with p = t (role 0) in edge order, then those
// with q = t (role 1).
struct Incidence {
  const int* start;
  const int* inc;
};

// The damped normal system of one window from its tile blocks and the TV
// edges (`tile_system`): jj(t, a, b) and jr(t, a) give the Gauss-Newton
// block and gradient of tile t; w.w2 and w.d hold the edges' weights and
// differences. Each thread assembles whole rows, adding in the plain
// version's order: the tile block, then the edges with p = t, then those
// with q = t (and -w2 below the diagonal, on the row of the larger tile).
template <class Blocks>
__device__ void assemble(const Work& w, const Blocks& blk, int T, int band,
                         const long long* p, const long long* q, Incidence at, float lam) {
  const int n = 2 * T;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int t = i >> 1, c = i & 1;
    float* Ai = w.A + i * row_floats(band);
    for (int k = 0; k < row_floats(band); ++k) Ai[k] = 0.0f;
    float diag = blk.jj(t, c, c);
    if (c == 1) Ai[1] = blk.jj(t, 1, 0);
    float b = blk.jr(t, c);
    for (int k = at.start[t]; k < at.start[t + 1]; ++k) {
      const int e = at.inc[k] >> 1;
      const float w2 = w.w2[e];
      diag = diag + w2;
      b = b + ((at.inc[k] & 1) ? -w2 : w2) * w.d[2 * e + c];
      const long long lo = p[e] < q[e] ? p[e] : q[e], hi = p[e] < q[e] ? q[e] : p[e];
      if (hi == t && lo != hi) Ai[2 * (hi - lo)] = Ai[2 * (hi - lo)] + (-w2);
    }
    // damping: A_ii + lam max(A_ii, 1e-8)
    Ai[0] = diag + lam * (diag < 1e-8f ? 1e-8f : diag);
    w.x[i] = b;
  }
  __syncthreads();
}

// Banded Cholesky of the assembled band, the forward substitution L y = b
// folded into it, by warp 0 (the lanes past B are idle), for band B: L's
// rows into the band in shared memory, y into w.x, each 1 / L(j, j) into
// w.inv. Returns whether every pivot was positive (not NaN), in warp 0.
// The plain version's bits cannot be had here: LAPACK sums in its own
// blocked order. Against a float64 solve the two are equally close (fused
// multiply-adds in the updates were no closer, on the emulated tests'
// systems). Each pivot's reciprocal is taken once and multiplies (as
// LAPACK's unblocked factorisation scales its column).
template <int B>
__device__ bool factor_band(const Work& w, int n, Clock& clk) {
  constexpr int R = B + 1;              // rows of the active window, one a lane
  constexpr int S = 2 * R;              // a lane's register slots: columns mod S
  constexpr int LD = (B + 4) / 4 * 4;   // row_floats(B)
  static_assert(R <= kLanes, "one row a lane");
  const int lane = threadIdx.x;
  const bool mine = lane < R;
  // a[c % S]: the lane's row r's entry in column c, for c in [r - B, r]; the
  // other R slots are spare: an update of a column past the row lands in
  // one of them (a column c in (r, r + B] is c - S there, below the band),
  // so the lanes past the pivot update without a test of their row, and the
  // row that enters next in the pivot's lane can be read into the pivot
  // row's spare slots ahead of time. x: the row's right-hand side.
  float a[S];
  float x = 0.0f;
  // rows 0..B enter: row `lane`'s columns 0..lane lie in slots 0..lane
#pragma unroll
  for (int c = 0; c < S; ++c)
    a[c] = mine && lane < n && c <= lane ? w.A[lane * LD + (lane - c)] : 0.0f;
  if (mine && lane < n) x = w.x[lane];
  // pivot j's diagonal entry and what follows from it, taken one pivot
  // ahead: 1 / L(j, j) by the reciprocal square root, and L(j, j)
  const float a00 = __shfl_sync(kFull, a[0], 0);
  if (!(a00 > 0.0f)) return false;
  float inv = rsqrtf(a00), ljj = a00 * inv;
  for (int j0 = 0; j0 < n; j0 += S) {
#pragma unroll
    for (int v = 0; v < S; ++v) {
      const int j = j0 + v;  // the pivot: column j in slot v, row j in lane u
      if (j >= n) break;     // the same in every lane
      const int u = v % R, u1 = (v + 1) % R, v1 = (v + 1) % S;
      const int o = lane - u + (lane < u ? R : 0);  // the lane's row is j + o
      const bool below = mine && o != 0;
      // the row that enters next in lane u, row j + R: its columns j + 1 ..
      // j + R into the pivot row's spare slots v + 1 .. v + R, read now
      const int e = j + R;
      float xe = 0.0f;
      if (lane == u && e < n) {
#pragma unroll
        for (int m = 0; m < R; ++m) a[(v + 1 + m) % S] = w.A[e * LD + (B - m)];
        xe = w.x[e];
      }
      a[v] = o == 0 ? ljj : a[v] * inv;  // column j of L
      // the column to every lane through shared memory (one store a lane,
      // then vector loads of the same addresses: one broadcast each)
      float* cb = w.col + 32 * (j & 1);
      if (mine) cb[o] = a[v];
      const float yj = __shfl_sync(kFull, x, u) * inv;
      // the update of row j + 1 first, then the next pivot's diagonal, so
      // that its square root runs beside this pivot's other updates
      const float l1 = __shfl_sync(kFull, a[v], u1);
      if (below) a[v1] = a[v1] - a[v] * l1;
      const float anext = __shfl_sync(kFull, a[v1], u1);
      const float inv_next = rsqrtf(anext), ljj_next = anext * inv_next;
      STAMP(kPivot);
      __syncwarp();
      float l[LD];
#pragma unroll
      for (int k = 0; k < LD; k += 4) {
        const float4 q = reinterpret_cast<const float4*>(cb)[k / 4];
        l[k] = q.x;
        l[k + 1] = q.y;
        l[k + 2] = q.z;
        l[k + 3] = q.w;
      }
      STAMP(kColumn);
      // the rest of the rank-1 update: entry (j + o, j + d), d = 2 .. B, in
      // every lane past the pivot (d > o: a spare slot)
#pragma unroll
      for (int d = 2; d < R; ++d)
        if (below) a[(v + d) % S] = a[(v + d) % S] - a[v] * l[d];
      if (below) x = x - a[v] * yj;
      STAMP(kUpdate);
      if (lane == u) {
        // row j leaves: L(j, j - k) into A[j][k]
        float4* out = reinterpret_cast<float4*>(w.A + j * LD);
#pragma unroll
        for (int k = 0; k < LD; k += 4)
          out[k / 4] = make_float4(a[(v - k + S) % S], k + 1 < R ? a[(v - k - 1 + S) % S] : 0.0f,
                                   k + 2 < R ? a[(v - k - 2 + S) % S] : 0.0f,
                                   k + 3 < R ? a[(v - k - 3 + S) % S] : 0.0f);
        x = xe;
      }
      if (lane == 0) {
        w.x[j] = yj;
        w.inv[j] = inv;
      }
      STAMP(kExchange);
      if (j + 1 < n && !(anext > 0.0f)) return false;
      inv = inv_next;
      ljj = ljj_next;
    }
  }
  __syncwarp();
  return true;
}

// L^T x = y by warp 0 after `factor_band<B>`, into w.x.
template <int B>
__device__ void back_band(const Work& w, int n) {
  constexpr int R = B + 1, LD = (B + 4) / 4 * 4;
  const int lane = threadIdx.x;
  const bool mine = lane < R;
  // from the bottom: lane l holds the running right-hand side z of
  // the window's row c = l mod R; at row j, x_j = z_j / L(j, j) goes to
  // every lane, which takes L(j, c) x_j off its z_c
  int c = n - 1 - ((n - 1 - lane) % R + R) % R;
  float z = mine && c >= 0 ? w.x[c] : 0.0f;
  // row j's entry L(j, j - o) of the lane's row, and 1 / L(j, j), read a
  // row ahead
  int p = (n - 1) % R;
  int o = p - lane + (p < lane ? R : 0);  // the lane's row is j - o
  float lj = mine && o >= 1 && o <= n - 1 ? w.A[(n - 1) * LD + o] : 0.0f;
  float ij = w.inv[n - 1];
  for (int j = n - 1; j >= 0; --j) {
    const float xj = __shfl_sync(kFull, z, p) * ij;
    const int pn = p == 0 ? R - 1 : p - 1, on = o == 0 ? R - 1 : o - 1;
    const float ln = mine && on >= 1 && on <= j - 1 ? w.A[(j - 1) * LD + on] : 0.0f;
    const float in = j >= 1 ? w.inv[j - 1] : 0.0f;
    const float ye = j >= R ? w.x[j - R] : 0.0f;  // row j - R's y, which enters in lane p
    if (mine && o >= 1 && o <= j) z = z - lj * xj;
    z = lane == p ? ye : z;
    if (lane == 0) w.x[j] = xj;
    p = pn;
    o = on;
    lj = ln;
    ij = in;
  }
}

// The block-wide factorisation, for the bands the register one is not
// built for (a 16-column grid's 32 needs 33 rows, more than a warp's
// lanes): over the block's four warps, two barriers a pivot, the update's
// entries found through a table; then the back substitution by one warp.
// The same arithmetic in the same order as `factor_band`, but for the
// reciprocal, IEEE's 1 / sqrtf here. Its clock marks: the factorisation as
// "pivot", the back substitution as "back".
__device__ bool factor_and_solve_block(const Work& w, int n, int band, Clock& clk) {
  const int tid = threadIdx.x, ld = row_floats(band), np = band * (band + 1) / 2;
  for (int ip = 1 + tid; ip <= band; ip += kThreads) {
    const int at = ip * (ip - 1) / 2;
    for (int kp = 1; kp <= ip; ++kp) w.pairs[at + kp - 1] = (ip << 16) | kp;
  }
  __syncthreads();
  for (int j = 0; j < n; ++j) {
    const float ajj = w.A[j * ld];
    if (!(ajj > 0.0f)) return false;  // the same for every thread
    const float ljj = sqrtf(ajj), inv = 1.0f / ljj;
    const float yj = w.x[j] * inv;  // x[j] has every update of the pivots before
    const int m = min(band, n - 1 - j);
    for (int ip = 1 + tid; ip <= m; ip += kThreads) w.A[(j + ip) * ld + ip] *= inv;
    __syncthreads();  // the column is scaled; A(j, j) and x[j] are read
    if (tid == 0) {
      w.inv[j] = inv;
      w.x[j] = yj;
    }
    // the rank-1 update, kBatch entries of a thread at a time: their loads
    // first, then their stores (no two entries of a pivot are one address,
    // but the compiler cannot tell, and would wait on each store)
    for (int u0 = tid; u0 < np; u0 += kBatch * kThreads) {
      float* at[kBatch];
      float val[kBatch];
      for (int k = 0; k < kBatch; ++k) {
        const int u = u0 + k * kThreads;
        const int ip = u < np ? w.pairs[u] >> 16 : 0, kp = u < np ? w.pairs[u] & 0xffff : 0;
        at[k] = ip >= 1 && ip <= m ? w.A + (j + ip) * ld + (ip - kp) : nullptr;
        val[k] = at[k] ? *at[k] - w.A[(j + ip) * ld + ip] * w.A[(j + kp) * ld + kp] : 0.0f;
      }
      for (int k = 0; k < kBatch; ++k)
        if (at[k]) *at[k] = val[k];
    }
    for (int ip = 1 + tid; ip <= m; ip += kThreads)
      w.x[j + ip] = w.x[j + ip] - w.A[(j + ip) * ld + ip] * yj;
    __syncthreads();
  }
  MARK(kPivot);
  // L^T x = y, from the bottom, by one warp
  if (tid < kLanes) {
    for (int j = n - 1; j >= 0; --j) {
      const float xj = w.x[j] * w.inv[j];
      const int m = min(band, j);
      __syncwarp();
      if (tid == 0) w.x[j] = xj;
      for (int ip = 1 + tid; ip <= m; ip += kLanes)
        w.x[j - ip] = w.x[j - ip] - w.A[j * ld + ip] * xj;
      __syncwarp();
    }
  }
  __syncthreads();
  MARK(kBack);
  return true;
}

// The factorisation and both substitutions for the window's band: by warp
// 0's registers for the main path's bands, 12 and 24, while the other warps wait,
// else block-wide (`factor_and_solve_block`); whether every pivot was
// positive is published to the block (every thread returns it).
__device__ bool factor_and_solve(const Work& w, int n, int band, Clock& clk) {
  if (band != 12 && band != 24) return factor_and_solve_block(w, n, band, clk);
  const bool lead = threadIdx.x < kLanes;
  bool good = false;
  if (lead) {
    switch (band) {
      case 12: good = factor_band<12>(w, n, clk); break;
      default: good = factor_band<24>(w, n, clk); break;
    }
    if (threadIdx.x == 0) w.flag[3] = good ? 1 : 0;
  }
  MARK(kExchange);  // the other warps' wait for the factorisation's end
  if (lead && good) {
    switch (band) {
      case 12: back_band<12>(w, n); break;
      default: back_band<24>(w, n); break;
    }
  }
  __syncthreads();
  MARK(kBack);
  return w.flag[3] != 0;
}

// Whether any entry of the solution is not finite (a barrier of the block).
__device__ bool any_not_finite(const Work& w, int n) {
  if (threadIdx.x == 0) w.flag[0] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += kThreads)
    if (!isfinite(w.x[i])) w.flag[0] = 1;  // every writer writes 1
  __syncthreads();
  return w.flag[0] != 0;
}

// The tile blocks given as arrays (the solve entry).
struct GivenBlocks {
  const float* blocks;     // [T, 2, 2]
  const float* gradients;  // [T, 2]
  __device__ float jj(int t, int a, int b) const { return blocks[4 * t + 2 * a + b]; }
  __device__ float jr(int t, int a) const { return gradients[2 * t + a]; }
};

// The tile blocks from the residuals and Jacobians (the loop):
// jj = J_a J_b, jr = J_a r, as the plain version's elementwise products.
struct ResidualBlocks {
  const float* J;  // [T, 2]
  const float* r;  // [T]
  __device__ float jj(int t, int a, int b) const { return J[2 * t + a] * J[2 * t + b]; }
  __device__ float jr(int t, int a) const { return J[2 * t + a] * r[t]; }
};

__global__ void __launch_bounds__(kThreads)
comp_solve_kernel(const float* __restrict__ jj, const float* __restrict__ jr,
                  const float* __restrict__ w2, const float* __restrict__ d,
                  const float* __restrict__ lam, const long long* __restrict__ p,
                  const long long* __restrict__ q, Incidence at, float* __restrict__ delta,
                  unsigned char* __restrict__ ok, int T, int E, int band) {
  extern __shared__ __align__(16) float smem[];
  const int win = blockIdx.x, tid = threadIdx.x, n = 2 * T;
  Work w = carve(smem, n, E, band);
  for (int e = tid; e < E; e += kThreads) {
    w.w2[e] = w2[(size_t)win * E + e];
    w.d[2 * e] = d[((size_t)win * E + e) * 2];
    w.d[2 * e + 1] = d[((size_t)win * E + e) * 2 + 1];
  }
  __syncthreads();
  GivenBlocks blk{jj + (size_t)win * 4 * T, jr + (size_t)win * n};
  assemble(w, blk, T, band, p, q, at, lam[win]);
  Clock clk;
  CLOCK_START();
  const bool good = factor_and_solve(w, n, band, clk);
  for (int i = tid; i < n; i += kThreads)
    delta[(size_t)win * n + i] = good ? -w.x[i] : NAN;
  if (tid == 0) ok[win] = good ? 1 : 0;
}

// The loop's state, [W, ...] each (the wrapper's arena).
struct LmState {
  float* v;            // [W, T, 2] the accepted velocities
  float* v_new;        // [W, T, 2] the candidate
  float* r;            // [W, T] residuals and Jacobians at v
  float* J;            // [W, T, 2]
  const float* r_new;  // [W, T] at v_new (kernel A)
  const float* J_new;  // [W, T, 2]
  float* lam;          // [W]
  float* cost;         // [W]
  float* cost0;        // [W]
  int* active;         // [W] 1 while the window iterates
  int* bad;            // [W] 1 when the candidate's step failed
  int* iters;          // [W] tails run while active
  long long* clocks;   // [W, kStages] or null (the clock build only)
};

struct LmShape {
  int T, E, band, mode;
  float tv_weight, tv_huber;
};

// The TV differences d = v_p - v_q of a window's edges into w.d.
__device__ void edge_diffs(const Work& w, const float* v, const long long* p,
                           const long long* q, int E) {
  for (int e = threadIdx.x; e < E; e += kThreads) {
    w.d[2 * e] = v[2 * p[e]] - v[2 * q[e]];
    w.d[2 * e + 1] = v[2 * p[e] + 1] - v[2 * q[e] + 1];
  }
  __syncthreads();
}

// sum r^2 + sum tv_rho(d) of one window (`compensate.tv_rho`), with d in
// w.d, by warp 0 in one fixed order (`compensate.lane_sum` is the same
// order), into *out.
__device__ void window_cost(const Work& w, const float* r, int T, int E, float tvw,
                            float huber, float* out) {
  const int lane = threadIdx.x;
  if (lane < kLanes) {
    float sr = 0.0f, st = 0.0f;
    for (int t = lane; t < T; t += kLanes) sr += r[t] * r[t];
    for (int e = lane; e < E; e += kLanes) {
      const float a = tvw * fabsf(w.d[2 * e]), b = tvw * fabsf(w.d[2 * e + 1]);
      const float s = a * a + b * b;
      const float nrm = sqrtf(s + 1e-12f);
      st += nrm <= huber ? s : (2.0f * huber) * nrm - huber * huber;
    }
    const float c = warp_sum(sr) + warp_sum(st);
    if (lane == 0) *out = c;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) comp_lm_step_kernel(LmState st, LmShape s,
                                                                const long long* __restrict__ p,
                                                                const long long* __restrict__ q,
                                                                Incidence at) {
  extern __shared__ __align__(16) float smem[];
  const int win = blockIdx.x, tid = threadIdx.x, T = s.T, E = s.E, n = 2 * T;
  if (!(s.mode & kInit) && st.active[win] != 1) return;  // stopped: nothing to do
  Clock clk;
  (void)clk;
  CLOCK_START();
  long long* clocks = st.clocks ? st.clocks + (size_t)win * kStages : nullptr;
  (void)clocks;
  Work w = carve(smem, n, E, s.band);
  float* shared_cost = reinterpret_cast<float*>(w.flag + 1);
  float* v = st.v + (size_t)win * n;
  float* v_new = st.v_new + (size_t)win * n;
  float* r = st.r + (size_t)win * T;
  float* J = st.J + (size_t)win * n;
  if (s.mode & kInit) {
    edge_diffs(w, v, p, q, E);
    window_cost(w, r, T, E, s.tv_weight, s.tv_huber, shared_cost);
    if (tid == 0) {
      st.cost[win] = *shared_cost;
      st.cost0[win] = *shared_cost;
      st.lam[win] = 1e-4f;
      st.active[win] = 1;
      st.bad[win] = 0;
      st.iters[win] = 0;
    }
    MARK(kInitCost);
  }
  float lam = s.mode & kInit ? 1e-4f : st.lam[win];
  if (s.mode & kTail) {
    const float* r_new = st.r_new + (size_t)win * T;
    const float* J_new = st.J_new + (size_t)win * n;
    edge_diffs(w, v_new, p, q, E);
    window_cost(w, r_new, T, E, s.tv_weight, s.tv_huber, shared_cost);
    const float cost_new = *shared_cost, cost = st.cost[win];
    const bool accept = isfinite(cost_new) && cost_new < cost && st.bad[win] == 0;
    const float rel = (cost - cost_new) / (cost < 1e-12f ? 1e-12f : cost);
    const bool done = (accept && rel < 1e-6f) || lam > 1e5f;
    if (accept) {
      for (int i = tid; i < n; i += kThreads) {
        v[i] = v_new[i];
        J[i] = J_new[i];
      }
      for (int t = tid; t < T; t += kThreads) r[t] = r_new[t];
    }
    const float up = accept ? lam * 0.5f : lam * 4.0f;
    lam = fminf(fmaxf(up, 1e-9f), 1e6f);
    __syncthreads();  // every thread has read the state; v, r, J are the accepted
    if (tid == 0) {
      if (accept) st.cost[win] = cost_new;
      st.lam[win] = lam;
      st.iters[win] += 1;
      if (done) st.active[win] = 0;
    }
    MARK(kTailCost);
    if (done) {
      CLOCK_OUT(clocks);
      return;
    }
  }
  if (s.mode & kHead) {
    edge_diffs(w, v, p, q, E);
    for (int e = tid; e < E; e += kThreads) {
      const float a = s.tv_weight * fabsf(w.d[2 * e]), b = s.tv_weight * fabsf(w.d[2 * e + 1]);
      const float nrm = sqrtf((a * a + b * b) + 1e-12f);
      // PyTorch takes `huber / n` of a Python number as (1 / n) * huber
      const float hw = nrm <= s.tv_huber ? 1.0f : (1.0f / nrm) * s.tv_huber;
      w.w2[e] = hw * s.tv_weight * s.tv_weight;
    }
    __syncthreads();
    MARK(kWeights);
    ResidualBlocks blk{J, r};
    assemble(w, blk, T, s.band, p, q, at, lam);
    MARK(kAssemble);
    const bool good = factor_and_solve(w, n, s.band, clk);
    const bool bad = !good || any_not_finite(w, n);
    for (int i = tid; i < n; i += kThreads) v_new[i] = v[i] + (bad ? 0.0f : -w.x[i]);
    if (tid == 0) st.bad[win] = bad ? 1 : 0;
    MARK(kCandidate);
  }
  CLOCK_OUT(clocks);
}

cudaError_t allow_smem(const void* kernel, size_t bytes, bool (&allowed)[64]) {
  if (bytes <= (size_t)kStaticSmem) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && dev < 64) allowed[dev] = true;
  return err;
}

bool bad_shape(int T, int E, int band) {
  return T < 1 || E < 0 || band < 1 || band > kMaxBand || band > 2 * T - 1
         || work_bytes(2 * T, E, band) > (size_t)kMaxSmem;
}

}  // namespace

// The C interface loaded with ctypes; each returns the CUDA error of its
// launch (0 = success). Pointers are device pointers of contiguous arrays;
// p, q [E] int64 tile ids of the TV edges, every |p - q| <= band / 2, and
// their incidence start [T + 1], inc [2 E] int32 (`Incidence`).

// W windows: jj [W, T, 2, 2], jr [W, T, 2], w2 [W, E], d [W, E, 2], lam [W]
// -> delta [W, T, 2] (NaN where the factorisation failed), ok [W] bytes.
extern "C" int evo_comp_solve(const float* jj, const float* jr, const float* w2,
                              const float* d, const float* lam, const long long* p,
                              const long long* q, const int* start, const int* inc,
                              float* delta, unsigned char* ok, int W, int T, int E, int band,
                              void* stream) {
  if (W == 0) return (int)cudaSuccess;
  if (bad_shape(T, E, band)) return (int)cudaErrorInvalidValue;
  static bool allowed[64];
  const size_t smem = work_bytes(2 * T, E, band);
  cudaError_t err = allow_smem((const void*)comp_solve_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  comp_solve_kernel<<<W, kThreads, smem, (cudaStream_t)stream>>>(
      jj, jr, w2, d, lam, p, q, Incidence{start, inc}, delta, ok, T, E, band);
  return (int)cudaGetLastError();
}

// One launch of the loop over W windows. `ptrs` holds LmState's pointers in
// its order; mode is a sum of 1 (the initial cost), 2 (the tail of a trip)
// and 4 (the head of the next).
extern "C" int evo_comp_lm_step(const void* const* ptrs, const long long* p,
                                const long long* q, const int* start, const int* inc, int W,
                                int T, int E, int band, int mode, float tv_weight,
                                float tv_huber, void* stream) {
  if (W == 0) return (int)cudaSuccess;
  if (bad_shape(T, E, band) || mode < 1 || mode > 7 || ((mode & kInit) && (mode & kTail)))
    return (int)cudaErrorInvalidValue;
  LmState st;
  st.v = (float*)ptrs[0];
  st.v_new = (float*)ptrs[1];
  st.r = (float*)ptrs[2];
  st.J = (float*)ptrs[3];
  st.r_new = (const float*)ptrs[4];
  st.J_new = (const float*)ptrs[5];
  st.lam = (float*)ptrs[6];
  st.cost = (float*)ptrs[7];
  st.cost0 = (float*)ptrs[8];
  st.active = (int*)ptrs[9];
  st.bad = (int*)ptrs[10];
  st.iters = (int*)ptrs[11];
  st.clocks = (long long*)ptrs[12];
  LmShape s{T, E, band, mode, tv_weight, tv_huber};
  static bool allowed[64];
  const size_t smem = work_bytes(2 * T, E, band);
  cudaError_t err = allow_smem((const void*)comp_lm_step_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  comp_lm_step_kernel<<<W, kThreads, smem, (cudaStream_t)stream>>>(st, s, p, q,
                                                                 Incidence{start, inc});
  return (int)cudaGetLastError();
}
