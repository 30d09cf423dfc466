// VO's windowed bundle adjustment as one CUDA kernel, one thread-block
// cluster a call: the whole LM loop, up to `num_iters` trips, with no host
// read until the end.
//
// Replaces `evo_tpu/vo/ba.py::ba_solve` (:98), one jitted XLA program in
// the JAX package (a `lax.while_loop` of LM trips, :243; no Pallas kernel),
// with its analytic linearization (`_obs_linearize`, :57), its 3x3 inverses
// (`_inv3`, :92) and the two-float sums of `evo_tpu/solve/precision.py`. The
// plain PyTorch version is `evo_tpu_torch/vo/ba.py::ba_solve_ref`.
//
// What bounds it: a trip moves a few hundred KB and does a few MFLOP (the
// Schur product dominates), microseconds at the card's rates; the trips are
// a chain, and inside a trip the reduced system's Cholesky is a chain of 6F
// pivots (126 at F 21). The first design ran everything in one block of one
// SM; its clock split (F 21, L 128, O 2048, 5 trips) put 47 % of the launch
// in the Schur product, 21 % in the factorisation (two block barriers a
// pivot), 11 % in the slot sums over a dense [L][F] pair grid. So now:
//  - the wide stages run over a cluster of C blocks (1 to 16; the wrapper
//    launches `kernels.ba_solve.CLUSTER`), separated by `cluster.sync()`;
//    the Schur entries and -v go into rank 0's shared memory through
//    distributed shared memory, rank 0 factors and solves, and every block
//    reads the step back the same way;
//  - once a launch the cluster compacts the observations' structure: a
//    table of each (landmark, frame) pair's first row in the pairs' order
//    (-1: no row; in each block's shared memory where it fits), each
//    frame's landmarks with a pair in index order, and where each
//    observation's linearization goes: its row in the frames' order, so
//    that the frames' long sums read their rows in sequence;
//  - A and T are dense by (frame, landmark), so that a Schur entry's loads
//    all follow from the landmark of frame f's list it is at;
//  - each stage of a trip (a thread an item, the cluster's threads in
//    turn):
//    1. a thread an observation: the residual, the Huber weight and the
//       analytic Jacobians (the plain `_obs_linearize` formulas);
//    2. the slots' sums, damped and pinned: a thread a row of a frame's Hpp
//       with its bp entry, a thread a landmark's Hll and bl (and its 3x3
//       inverse by LU with the failure flag), a thread a pair's A; each
//       entry summed serially over its slot's observations in the order the
//       caller gives (`SegmentSum`'s: by slot, then (landmark, frame), then
//       index, masked observations left out), or, with `compensated`, in
//       `compensated_scatter_add`'s: the rows by slot and index, in chunks
//       of ceil(O / 32) rows, the chunks' partial sums added by a two-float
//       sum;
//    3. T = A Hll^-1 for each pair;
//    4. the reduced system S = Hpp - sum_l T_lf A_lg^T (its lower triangle)
//       and -v: a warp a 6x6 block of S (the diagonal blocks with -v's
//       entries), a lane an entry or two, each summed over the landmarks
//       both frames see, in index order;
//    5. on rank 0: the Cholesky of S by the frames' 6-column panels with a
//       look-ahead (the block updates the next panel's columns, then warp 0
//       factors it in its registers while the other warps update the rest
//       of the trailing triangle: two barriers a panel), the two triangular
//       solves in warp 0's registers (no barrier), the step's check as one
//       block reduction;
//    6. landmark back-substitution (over their frames in index order) and
//       `se3_retract` of the free poses, into the other of two state
//       buffers;
//    7. the candidate's Huber cost in float64 (a residual is a difference
//       of pixel coordinates of ~100 px, so a float32 cost is good to ~1e-6
//       of itself while the stop test weighs decreases of tol, 1e-5, of it)
//       and in float32, each summed by rank 0's warp 0 in a fixed order;
//    8. rank 0's thread 0: accept and stop on the float64 costs, a zero
//       float32 cost final (`vo.ba.decide`), the damping's update.
// Every entry keeps the first design's sequence of float operations (each
// slot sum, each Schur entry, each factor entry's updates one k at a time in
// ascending k, the solves, the back-substitution, the costs' warp sums), so
// it gives that design's bits. No atomics, no sum whose order depends on the
// block's or the cluster's size: the same inputs give the same bits on
// every run, at any block size and any cluster size.
//
// Built with -fmad=false. The clock build (-DEVO_BA_CLOCKS, a library of
// its own) writes the cycles of each stage, summed over the trips, into
// `clocks` (`Stage`, `kernels.ba_solve.STAGES`); the plain build ignores the
// pointer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "vo_geometry.cuh"

namespace cg = cooperative_groups;

// the largest block, which sets the registers a thread may have (65,536 /
// EVO_BA_MAX_THREADS, at most 255)
#ifndef EVO_BA_MAX_THREADS
#define EVO_BA_MAX_THREADS 256
#endif

namespace {

constexpr int kChunks = 32;  // compensated_scatter_add's n_chunks
constexpr int kLin = 21;     // an observation's r [2], w, Jp [2][6], Jl [2][3]
constexpr int kMaxFrames = 39;                          // kernels.ba_solve.MAX_FRAMES
constexpr int kMaxRows = (6 * kMaxFrames + 31) / 32;    // a lane's rows of S (8)
static_assert(kMaxRows <= 8, "EVO_DISPATCH8 covers 1 to 8");

// `call<M>(args)` for M = m, a run-time count from 1 to 8 (kMaxRows)
#define EVO_DISPATCH8(m, call, ...)  \
  switch (m) {                       \
    case 1: call<1>(__VA_ARGS__); break; \
    case 2: call<2>(__VA_ARGS__); break; \
    case 3: call<3>(__VA_ARGS__); break; \
    case 4: call<4>(__VA_ARGS__); break; \
    case 5: call<5>(__VA_ARGS__); break; \
    case 6: call<6>(__VA_ARGS__); break; \
    case 7: call<7>(__VA_ARGS__); break; \
    default: call<8>(__VA_ARGS__); break; \
  }

constexpr int kMaxCluster = 16;
constexpr int kCtrl = 16;  // the floats of shared memory that hold `Ctrl`
constexpr size_t kSmemMax = 232448;  // a block's shared memory on sm_90
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* poses_in;
  const float* lms_in;
  const float* intr;
  const int64_t* of;
  const int64_t* ol;
  const float* p2d;
  const uint8_t* mask;
  const uint8_t* fixed;
  // the observations by frame, by landmark and by (landmark, frame) pair,
  // and each slot's start in that order ([F + 1], [L + 1], [L F + 1])
  const int64_t *perm_f, *f_start, *perm_l, *l_start, *perm_p, *p_start;
  int F, L, O, num_iters, compensated;
  int pos_shared;  // whether each block keeps the pairs' table in its shared memory
  double huber, two_huber, huber_sq, tol;
  float* fs;      // float scratch (`Layout`)
  int* is;        // int scratch (`Layout`)
  float* poses;   // [F][7]: the accepted poses, the result
  float* lms;     // [L][3]: the accepted landmarks, the result
  float* costs;   // [2]: cost, cost0
  int* iters;     // [1]
  long long* clocks;  // [kStages], the clock build's
};

// the solve's control, in rank 0's shared memory (every block reads it
// there after a cluster barrier)
struct Ctrl {
  double cost;
  float cost32, lam;
  int done, accept, fail, bad, cur;  // cur: the state buffer that holds the accepted state
};

// offsets into the scratch, in floats; the float64 `rho` first, so that it
// lies on the scratch's 8-byte alignment
struct Layout {
  int rho, rho32, lin, hpp, bp, hll, bl, hinv, a, t, poses_new, lms_new, n_float;
  // ints
  int has_obs, inv_info, pair_of, lin_row, row_l, row_p, pos, list_l, list_n, n_int;
  __device__ __host__ Layout(int F, int L, int O) {
    int x = 0;
    rho = x; x += 2 * O;
    rho32 = x; x += O;
    lin = x; x += O * kLin;
    hpp = x; x += F * 36;
    bp = x; x += F * 6;
    hll = x; x += L * 9;
    bl = x; x += L * 3;
    hinv = x; x += L * 9;
    a = x; x += F * L * 18;  // A [F][L][6][3], dense by (frame, landmark)
    t = x; x += F * L * 18;  // T, likewise
    poses_new = x; x += F * 7;
    lms_new = x; x += L * 3;
    n_float = x;
    x = 0;
    has_obs = x; x += L;
    inv_info = x; x += L;
    pair_of = x; x += O;    // the pair whose rows start at row q of the pairs' order, else -1
    lin_row = x; x += O;    // each observation's linearization: its row in the frames' order
    row_l = x; x += O;      // the linearization of row q of the landmarks' order
    row_p = x; x += O;      // and of the pairs'
    pos = x; x += L * F;    // the first row of pair l F + f in the pairs' order, else -1
    list_l = x; x += F * L;  // frame f's landmarks with a row, in index order
    list_n = x; x += F;
    n_int = x;
  }
};

// Stage clock (-DEVO_BA_CLOCKS only): rank 0's thread 0 adds the clock64()
// cycles since the previous mark into a stage's bin. Each mark comes after a
// barrier (of the cluster, or of rank 0 for the stages that only rank 0
// runs), so a stage's time is its slowest thread's, and the stages add up
// to the total.
enum Stage { kSetup, kLinearize, kSlots, kInverses, kSchur, kFactor, kSolves, kStep, kCost,
             kDecide, kTotal, kStages };
#ifdef EVO_BA_CLOCKS
struct Clock {
  bool owner;
  long long last, start, bins[kStages];
};
__device__ void clock_start(Clock& clk, bool owner) {
  clk.owner = owner;
  clk.start = clk.last = clock64();
  for (int k = 0; k < kStages; ++k) clk.bins[k] = 0;
}
__device__ void stamp(Clock& clk, int stage) {
  if (clk.owner) {
    const long long t = clock64();
    clk.bins[stage] += t - clk.last;
    clk.last = t;
  }
}
__device__ void clock_out(Clock& clk, long long* out) {
  if (clk.owner && out != nullptr) {
    clk.bins[kTotal] = clk.last - clk.start;
    for (int k = 0; k < kStages; ++k) out[k] = clk.bins[k];
  }
}
#define CLOCK_START(owner) \
  Clock clk;               \
  clock_start(clk, owner)
#define STAMP(stage) stamp(clk, stage)
#define CLOCK_OUT(out) clock_out(clk, out)
#else
#define CLOCK_START(owner)
#define STAMP(stage) ((void)0)
#define CLOCK_OUT(out) ((void)0)
#endif

__device__ __forceinline__ void two_sum(float& hi, float& lo, float x) {
  const float s = hi + x;
  const float bp = s - hi;
  const float err = (hi - (s - bp)) + (x - bp);
  hi = s;
  lo = lo + err;
}

// out[e], e < N: the sum of values(row)[e] over the observations
// perm[begin:end] (their linearizations at rows[q], or at q where `rows` is
// null): in that order, or with `chunk` > 0 the partial sums of each chunk
// of `chunk` observations (by index) added by a two-float sum and folded.
// Each e is summed as if alone; the N sums share the rows' loads, and the
// plain sums load U rows ahead of their additions.
template <int N, int U, class V>
__device__ void seg_sums(const int64_t* perm, const int* rows, int begin, int end, int chunk,
                         V values, float* out) {
  float part[N], v[N];
#pragma unroll
  for (int e = 0; e < N; ++e) part[e] = 0.0f;
  if (chunk == 0) {
    int q = begin;
    for (; q + U <= end; q += U) {
      float vu[U][N];
#pragma unroll
      for (int u = 0; u < U; ++u) values(rows ? rows[q + u] : q + u, vu[u]);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < N; ++e) part[e] = part[e] + vu[u][e];
    }
    for (; q < end; ++q) {
      values(rows ? rows[q] : q, v);
#pragma unroll
      for (int e = 0; e < N; ++e) part[e] = part[e] + v[e];
    }
#pragma unroll
    for (int e = 0; e < N; ++e) out[e] = part[e];
    return;
  }
  float hi[N], lo[N];
#pragma unroll
  for (int e = 0; e < N; ++e) hi[e] = lo[e] = 0.0f;
  int cur = -1;
  for (int q = begin; q < end; ++q) {
    const int k = (int)perm[q] / chunk;
    if (k != cur) {
      if (cur >= 0) {
#pragma unroll
        for (int e = 0; e < N; ++e) two_sum(hi[e], lo[e], part[e]);
      }
#pragma unroll
      for (int e = 0; e < N; ++e) part[e] = 0.0f;
      cur = k;
    }
    values(rows ? rows[q] : q, v);
#pragma unroll
    for (int e = 0; e < N; ++e) part[e] = part[e] + v[e];
  }
  if (cur >= 0) {
#pragma unroll
    for (int e = 0; e < N; ++e) two_sum(hi[e], lo[e], part[e]);
  }
#pragma unroll
  for (int e = 0; e < N; ++e) out[e] = hi[e] + lo[e];
}

// the inverse of a 3x3 matrix by LU with partial pivoting; returns
// `inv_ex`'s info: 0, or 1 + the first column whose pivot is exactly 0
__device__ int inv3(const float* m, float* out) {
  float a[3][3];
  int perm[3] = {0, 1, 2};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) a[i][j] = m[3 * i + j];
  int info = 0;
  for (int k = 0; k < 3; ++k) {
    int p = k;
    float best = fabsf(a[k][k]);
    for (int i = k + 1; i < 3; ++i)
      if (fabsf(a[i][k]) > best) {
        best = fabsf(a[i][k]);
        p = i;
      }
    if (p != k) {
      for (int j = 0; j < 3; ++j) {
        const float s = a[k][j];
        a[k][j] = a[p][j];
        a[p][j] = s;
      }
      const int s = perm[k];
      perm[k] = perm[p];
      perm[p] = s;
    }
    if (a[k][k] == 0.0f) {
      if (info == 0) info = k + 1;
      continue;
    }
    for (int i = k + 1; i < 3; ++i) {
      a[i][k] = a[i][k] / a[k][k];
      for (int j = k + 1; j < 3; ++j) a[i][j] = a[i][j] - a[i][k] * a[k][j];
    }
  }
  for (int c = 0; c < 3; ++c) {
    float x[3];
    for (int i = 0; i < 3; ++i) {
      float s = perm[i] == c ? 1.0f : 0.0f;
      for (int k = 0; k < i; ++k) s = s - a[i][k] * x[k];
      x[i] = s;
    }
    for (int i = 2; i >= 0; --i) {
      float s = x[i];
      for (int k = i + 1; k < 3; ++k) s = s - a[i][k] * x[k];
      x[i] = s / a[i][i];
    }
    for (int i = 0; i < 3; ++i) out[3 * i + c] = x[i];
  }
  return info;
}

// one observation's residual, Huber weight (times its mask) and Jacobians
// in the pose tangent and the landmark (`_obs_linearize`, `huber_weights`;
// a fixed frame's Jp is zero)
__device__ void linearize_obs(const Args& a, int o, const float* pose, const float* lm,
                              float* out) {
  float R[9], d[3], pc[3], pix[2], Jpi[6];
  vo::quat_to_matrix(pose, R);
  for (int i = 0; i < 3; ++i) d[i] = lm[i] - pose[4 + i];
  for (int i = 0; i < 3; ++i) pc[i] = R[i] * d[0] + R[3 + i] * d[1] + R[6 + i] * d[2];
  vo::project(a.intr, pc, pix);
  const float r0 = a.p2d[2 * o] - pix[0], r1 = a.p2d[2 * o + 1] - pix[1];
  vo::project_jacobian(a.intr, pc, Jpi);
  const float s = r0 * r0 + r1 * r1;
  const float n = sqrtf(s + 1e-12f);
  const float huber = (float)a.huber;
  const float w = (n <= huber ? 1.0f : huber / n) * (a.mask[o] ? 1.0f : 0.0f);
  const bool fixed = a.fixed[a.of[o]] != 0;
  out[0] = r0;
  out[1] = r1;
  out[2] = w;
  for (int r = 0; r < 2; ++r) {
    const float m0 = -Jpi[3 * r], m1 = -Jpi[3 * r + 1], m2 = -Jpi[3 * r + 2];
    float* jp = out + 3 + 6 * r;
    jp[0] = Jpi[3 * r];
    jp[1] = Jpi[3 * r + 1];
    jp[2] = Jpi[3 * r + 2];
    // -Jpi [p_c]x, each row's zero term adding exactly
    jp[3] = m0 * 0.0f + m1 * pc[2] + m2 * -pc[1];
    jp[4] = m0 * -pc[2] + m1 * 0.0f + m2 * pc[0];
    jp[5] = m0 * pc[1] + m1 * -pc[0] + m2 * 0.0f;
    if (fixed)
      for (int k = 0; k < 6; ++k) jp[k] = 0.0f;
    // -Jpi R^T
    float* jl = out + 15 + 3 * r;
    for (int k = 0; k < 3; ++k) jl[k] = m0 * R[3 * k] + m1 * R[3 * k + 1] + m2 * R[3 * k + 2];
  }
}

// the Huber rho of one observation's reprojection (`ba_solve`'s
// robust_cost, before the sum) in float or double, times its mask
template <class T>
__device__ T robust_rho(const Args& a, int o, const float* pose32, const float* lm32) {
  T pose[7], lm[3], k[9], inv[7], pc[3], pix[2];
  for (int i = 0; i < 7; ++i) pose[i] = pose32[i];
  for (int i = 0; i < 3; ++i) lm[i] = lm32[i];
  for (int i = 0; i < 9; ++i) k[i] = a.intr[i];
  vo::se3_inverse(pose, inv);
  vo::se3_apply(inv, lm, pc);
  vo::project(k, pc, pix);
  const T r0 = (T)a.p2d[2 * o] - pix[0], r1 = (T)a.p2d[2 * o + 1] - pix[1];
  const T s = r0 * r0 + r1 * r1;
  const T n = sqrt(s + (T)1e-12);
  const T rho = n <= (T)a.huber ? s : (T)a.two_huber * n - (T)a.huber_sq;
  return a.mask[o] ? rho : T(0);
}

// the sum of x[0:O] by one warp: lane j adds rows j, j + 32, ... in order,
// then the lanes' sums in a fixed tree; the result on every lane
template <class T>
__device__ T warp_sum(const T* x, int O) {
  const int lane = threadIdx.x & 31;
  T s = 0;
  for (int o = lane; o < O; o += 32) s = s + x[o];
  for (int d = 16; d > 0; d >>= 1) s = s + __shfl_xor_sync(kFull, s, d);
  return s;
}

// each observation's rho in float64 and float32, a thread an observation of
// the cluster's `G` threads
__device__ void costs(const Args& a, const float* poses, const float* lms, double* rho,
                      float* rho32, int gt, int G) {
  for (int o = gt; o < a.O; o += G) {
    const float* pose = poses + 7 * a.of[o];
    const float* lm = lms + 3 * a.ol[o];
    rho[o] = robust_rho<double>(a, o, pose, lm);
    rho32[o] = robust_rho<float>(a, o, pose, lm);
  }
}

// Warp 0's factorisation of the 6-column panel at column c0, held in its
// registers (v[m][jj]: row c0 + lane + 32 m, column c0 + jj, already
// updated by every earlier column): each pivot's square root, its column
// divided, the panel's later columns updated, each broadcast by a shuffle.
// Returns false at a pivot that is not positive.
template <int M>
__device__ bool panel_factor(float (&v)[M][6], int c0, int n, float* diag) {
  const int lane = threadIdx.x & 31, rows = n - c0;
  bool ok = true;
#pragma unroll
  for (int kk = 0; kk < 6; ++kk) {
    const float piv = __shfl_sync(kFull, v[0][kk], kk);
    ok = ok && piv > 0.0f;
    if (ok) {
      const float d = sqrtf(piv);
      if (lane == 0) diag[c0 + kk] = d;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int ri = lane + 32 * m;
        if (ri > kk && ri < rows) v[m][kk] = v[m][kk] / d;
      }
    }
#pragma unroll
    for (int jj = kk + 1; jj < 6; ++jj) {
      const float ljk = __shfl_sync(kFull, v[0][kk], jj);
      if (ok) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int ri = lane + 32 * m;
          if (ri >= jj && ri < rows) v[m][jj] = v[m][jj] - v[m][kk] * ljk;
        }
      }
    }
  }
  return ok;
}

// warp 0: the panel at column c1 loaded into its registers, factored and
// stored; a pivot that is not positive sets `ctrl->fail`
template <int M>
__device__ void factor_panel(float* S, float* diag, int n, int c1, Ctrl* ctrl) {
  const int lane = threadIdx.x & 31, rows = n - c1;
  float v[M][6];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int ri = lane + 32 * m;
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) v[m][jj] = ri < rows ? S[(c1 + ri) * n + c1 + jj] : 0.0f;
  }
  if (!panel_factor<M>(v, c1, n, diag)) {
    if (lane == 0) ctrl->fail = 1;
    return;
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int ri = lane + 32 * m;
#pragma unroll
    for (int jj = 0; jj < 6; ++jj)
      if (ri >= jj && ri < rows) S[(c1 + ri) * n + c1 + jj] = v[m][jj];
  }
}

// S[i][j] minus the products of rows i and j of the factored panel at c0,
// one k at a time in ascending k
__device__ __forceinline__ void panel_update(float* S, int n, int c0, int i, int j) {
  const float* Li = S + i * n + c0;
  const float* Lj = S + j * n + c0;
  float s = S[i * n + j];
#pragma unroll
  for (int kk = 0; kk < 6; ++kk) s = s - Li[kk] * Lj[kk];
  S[i * n + j] = s;
}

// The Cholesky of S's lower triangle [n][n] in place (L below the
// diagonal, its diagonal in `diag`), by the frames' 6-column panels with a
// look-ahead: once the panel at c0 is factored, the block updates the next
// panel's columns with it; then warp 0 factors the next panel in its
// registers while the other warps update the rest of the trailing triangle
// with the panel at c0 (a warp a row, a lane a column): two barriers a
// panel. Every entry sees the operations of the pivot-at-a-time algorithm in
// its order (its updates one k at a time in ascending k). A pivot that is
// not positive sets `ctrl->fail` and ends it. Rank 0's threads. Each panel
// is factored with M = ceil(rows / 32), a lane's rows below its first
// column, a template argument so that they stay in registers.
__device__ void factor(float* S, float* diag, int n, Ctrl* ctrl) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  if (warp == 0) {
    EVO_DISPATCH8((n + 31) >> 5, factor_panel, S, diag, n, 0, ctrl);
  }
  __syncthreads();
  for (int c0 = 0; c0 + 6 < n; c0 += 6) {
    if (ctrl->fail) return;
    const int c1 = c0 + 6;
    // the next panel's columns: entries (i, c1 + jj), i >= c1 + jj
    for (int e = tid; e < (n - c1) * 6; e += blockDim.x) {
      const int i = c1 + e / 6, j = c1 + e % 6;
      if (i >= j) panel_update(S, n, c0, i, j);
    }
    __syncthreads();
    if (warp == 0) {
      EVO_DISPATCH8((n - c1 + 31) >> 5, factor_panel, S, diag, n, c1, ctrl);
    } else {
      for (int i = c1 + 6 + warp - 1; i < n; i += nw - 1)
        for (int j = c1 + 6 + lane; j <= i; j += 32) panel_update(S, n, c0, i, j);
    }
    __syncthreads();
  }
}

// L y = rhs, then L^T x = y, in place, by warp 0: a lane holds rows lane,
// lane + 32, ... of the right-hand side in registers; each step's quotient
// goes to the other lanes by a shuffle from the row's lane, and the next
// step's column of L is loaded a step ahead. The steps run in blocks of 32
// (the rows of one register), so that every register index is known at
// compile time. M as in `factor`.
template <int M>
__device__ void solves(const float* S, const float* diag, float* rhs, int n) {
  const int lane = threadIdx.x & 31;
  float y[M], col[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = lane + 32 * m;
    y[m] = i < n ? rhs[i] : 0.0f;
    col[m] = i < n ? S[i * n] : 0.0f;  // column 0
  }
#pragma unroll
  for (int mm = 0; mm < M; ++mm) {
    const int kend = n - 32 * mm < 32 ? n - 32 * mm : 32;
    for (int kk = 0; kk < kend; ++kk) {
      const int k = 32 * mm + kk;
      float now[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        now[m] = col[m];
        const int i = lane + 32 * m;
        col[m] = i < n && k + 1 < n ? S[i * n + k + 1] : 0.0f;
      }
      const float yk = __shfl_sync(kFull, y[mm], kk) / diag[k];
#pragma unroll
      for (int m = mm; m < M; ++m) {
        const int i = lane + 32 * m;
        if (i > k && i < n) y[m] = y[m] - now[m] * yk;
      }
      if (lane == kk) y[mm] = yk;
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int i = lane + 32 * m;
    col[m] = i < n - 1 ? S[(n - 1) * n + i] : 0.0f;  // row n - 1
  }
#pragma unroll
  for (int mm = M - 1; mm >= 0; --mm) {
    const int kend = n - 32 * mm < 32 ? n - 32 * mm : 32;
    for (int kk = kend - 1; kk >= 0; --kk) {
      const int k = 32 * mm + kk;
      float now[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        now[m] = col[m];
        const int i = lane + 32 * m;
        col[m] = k > 0 && i < k - 1 ? S[(k - 1) * n + i] : 0.0f;
      }
      const float xk = __shfl_sync(kFull, y[mm], kk) / diag[k];
#pragma unroll
      for (int m = 0; m <= mm; ++m) {
        const int i = lane + 32 * m;
        if (i < k) y[m] = y[m] - now[m] * xk;
      }
      if (lane == kk) y[mm] = xk;
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
    if (lane + 32 * m < n) rhs[lane + 32 * m] = y[m];
}

// The reduced system into rank 0's S and rhs, a warp a 6x6 block (f, g),
// f >= g (blocks gw, gw + GW, ...): lane j takes entries j and j + 32 of the
// block's list (all 36 (i, k) where f > g; where f == g the 21 with i >= k,
// then -v's 6 entries of frame f). Each sums over frame f's landmarks in
// index order, those that frame g sees too: acc + T_lf[i] . A_lg[k] (or
// . bl_l), then -acc (+ Hpp's entry). A and T are dense by (frame,
// landmark): the lanes' loads of one landmark fall on one row of each, and
// E landmarks' loads are issued ahead of their additions.
__device__ void schur_blocks(int gw, int GW, int n, int F, int L, const int* list_l,
                             const int* list_n, const int* pos, const float* T, const float* A,
                             const float* bl, const float* hpp, const float* bp, float* S0,
                             float* rhs0) {
  constexpr int E = 8;
  const int lane = threadIdx.x & 31, nb = F * (F + 1) / 2;
  for (int blk = gw; blk < nb; blk += GW) {
    int f = (int)((sqrtf(8.0f * blk + 1.0f) - 1.0f) * 0.5f);
    while (f * (f + 1) / 2 > blk) --f;
    while ((f + 1) * (f + 2) / 2 <= blk) ++f;
    const int g = blk - f * (f + 1) / 2, diag_blk = f == g;
    const int nj = diag_blk ? 27 : 36;
    // a job: (i, k) of S, or (i, -1) for -v's entry i
    int ji[2], jk[2];
    bool on[2];
    float acc[2] = {0.0f, 0.0f};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = lane + 32 * t;
      on[t] = j < nj;
      if (!diag_blk) {
        ji[t] = j / 6;
        jk[t] = j % 6;
      } else if (j < 21) {  // the lower triangle, row by row
        int i = 0;
        while ((i + 1) * (i + 2) / 2 <= j) ++i;
        ji[t] = i;
        jk[t] = j - i * (i + 1) / 2;
      } else {
        ji[t] = j - 21;
        jk[t] = -1;
      }
      if (!on[t]) ji[t] = jk[t] = 0;
    }
    const int cnt = list_n[f];
    const int* ll = list_l + f * L;
    for (int e0 = 0; e0 < cnt; e0 += E) {
      float tv[E][2][3], av[E][2][3];
      bool use[E];
#pragma unroll
      for (int u = 0; u < E; ++u) {
        const int l = e0 + u < cnt ? ll[e0 + u] : 0;
        use[u] = e0 + u < cnt && (diag_blk || pos[l * F + g] >= 0);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float* tr = T + (f * L + l) * 18 + 3 * ji[t];
          const float* ar = jk[t] >= 0 ? A + (g * L + l) * 18 + 3 * jk[t] : bl + 3 * l;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            tv[u][t][c] = use[u] && on[t] ? tr[c] : 0.0f;
            av[u][t][c] = use[u] && on[t] ? ar[c] : 0.0f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < E; ++u)
        if (use[u])
#pragma unroll
          for (int t = 0; t < 2; ++t)
            acc[t] = acc[t] + (tv[u][t][0] * av[u][t][0] + tv[u][t][1] * av[u][t][1] +
                               tv[u][t][2] * av[u][t][2]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (!on[t]) continue;
      const int r = 6 * f + ji[t];
      if (jk[t] >= 0) {
        float s = -acc[t];
        if (diag_blk) s = s + hpp[36 * f + 6 * ji[t] + jk[t]];
        S0[r * n + 6 * g + jk[t]] = s;
      } else {
        rhs0[r] = -(bp[6 * f + ji[t]] - acc[t]);
      }
    }
  }
}

__global__ void __launch_bounds__(EVO_BA_MAX_THREADS) ba_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int F = a.F, L = a.L, O = a.O, n = 6 * F;
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  // the cluster's threads and warps (the grid is one cluster)
  const int gt = rank * nt + tid, G = (int)gridDim.x * nt;
  const int gw = rank * (nt >> 5) + warp, GW = (int)gridDim.x * (nt >> 5);
  // shared: the control (rank 0's is the solve's), S [n][n] (the lower
  // triangle; rank 0's), -v and then the step (rank 0's), the factor's
  // diagonal, the step as each block reads it
  Ctrl* ctrl = reinterpret_cast<Ctrl*>(smem);
  float* S = smem + kCtrl;
  float* rhs = S + n * n;
  float* diag = rhs + n;
  float* dp = diag + n;
  Ctrl* ctrl0 = cluster.map_shared_rank(ctrl, 0);
  float* S0 = cluster.map_shared_rank(S, 0);
  float* rhs0 = cluster.map_shared_rank(rhs, 0);
  const Layout lay(F, L, O);
  double* rho = reinterpret_cast<double*>(a.fs + lay.rho);
  float* rho32 = a.fs + lay.rho32;
  float* lin = a.fs + lay.lin;  // [O][kLin], in the frames' order
  float* hpp = a.fs + lay.hpp;
  float* bp = a.fs + lay.bp;
  float* hll = a.fs + lay.hll;
  float* bl = a.fs + lay.bl;
  float* hinv = a.fs + lay.hinv;
  float* A = a.fs + lay.a;  // [F][L][6][3]
  float* T = a.fs + lay.t;  // [F][L][6][3]
  int* has_obs = a.is + lay.has_obs;
  int* inv_info = a.is + lay.inv_info;
  int* pair_of = a.is + lay.pair_of;
  int* lin_row = a.is + lay.lin_row;
  int* row_l = a.is + lay.row_l;
  int* row_p = a.is + lay.row_p;
  // the pairs' table, which every Schur entry reads: each block's own copy
  // in its shared memory where it fits, else one in the scratch
  int* pos = a.pos_shared ? reinterpret_cast<int*>(dp + n) : a.is + lay.pos;
  int* list_l = a.is + lay.list_l;
  int* list_n = a.is + lay.list_n;
  // the two state buffers: the accepted state and the candidate, by turns
  float* const buf_p[2] = {a.poses, a.fs + lay.poses_new};
  float* const buf_l[2] = {a.lms, a.fs + lay.lms_new};
  const int chunk = a.compensated ? (O + kChunks - 1) / kChunks : 0;
  CLOCK_START(rank == 0 && tid == 0);

  // -- once a launch: the state, the landmarks with an observation that
  // counts, where each observation's linearization goes (its row in the
  // frames' order, which the frames' long sums then read in sequence), the
  // pairs' table and first rows, the initial cost
  for (int i = gt; i < F * 7; i += G) a.poses[i] = a.poses_in[i];
  for (int i = gt; i < L * 3; i += G) a.lms[i] = a.lms_in[i];
  for (int l = gt; l < L; l += G) {
    int any = 0;
    for (int64_t q = a.l_start[l]; q < a.l_start[l + 1]; ++q) any |= a.mask[a.perm_l[q]] ? 1 : 0;
    has_obs[l] = any;
  }
  for (int q = gt; q < O; q += G) lin_row[a.perm_f[q]] = q;
  for (int p = a.pos_shared ? tid : gt; p < L * F; p += a.pos_shared ? nt : G)
    pos[p] = a.p_start[p + 1] > a.p_start[p] ? (int)a.p_start[p] : -1;
  const int n_pq = (int)a.p_start[L * F];  // the rows of the pairs' sums
  for (int q = gt; q < n_pq; q += G) {
    const int o = (int)a.perm_p[q];
    const int p = (int)(a.ol[o] * F + a.of[o]);
    bool first = q == 0;
    if (!first) {
      const int o1 = (int)a.perm_p[q - 1];
      first = (int)(a.ol[o1] * F + a.of[o1]) != p;
    }
    pair_of[q] = first ? p : -1;
  }
  costs(a, a.poses_in, a.lms_in, rho, rho32, gt, G);
  if (rank == 0 && tid == 0) {
    ctrl->lam = 1e-4f;
    ctrl->done = 0;
    ctrl->cur = 0;
  }
  cluster.sync();
  for (int q = gt; q < O; q += G) row_l[q] = lin_row[a.perm_l[q]];
  for (int q = gt; q < n_pq; q += G) row_p[q] = lin_row[a.perm_p[q]];
  // each frame's landmarks with a pair, in index order: a warp a frame
  for (int f = gw; f < F; f += GW) {
    int cnt = 0;
    for (int base = 0; base < L; base += 32) {
      const int l = base + lane;
      const bool has = l < L && pos[l * F + f] >= 0;
      const unsigned m = __ballot_sync(kFull, has);
      if (has) list_l[f * L + cnt + __popc(m & ((1u << lane) - 1u))] = l;
      cnt += __popc(m);
    }
    if (lane == 0) list_n[f] = cnt;
  }
  if (rank == 0 && warp == 0) {
    const double c = warp_sum(rho, O);
    const float c32 = warp_sum(rho32, O);
    if (lane == 0) {
      ctrl->cost = c;
      ctrl->cost32 = c32;
      a.costs[1] = (float)c;
    }
  }
  cluster.sync();
  STAMP(kSetup);

  int it = 0;
  while (it < a.num_iters) {
    const float lam = ctrl0->lam;
    const int cur = ctrl0->cur;
    const float* poses = buf_p[cur];
    const float* lms = buf_l[cur];
    float* poses_c = buf_p[1 - cur];
    float* lms_c = buf_l[1 - cur];
    // 1. linearize every observation at the accepted state, into its row in
    // the frames' order
    for (int q = gt; q < O; q += G) {
      const int o = (int)a.perm_f[q];
      linearize_obs(a, o, poses + 7 * a.of[o], lms + 3 * a.ol[o], lin + kLin * q);
    }
    cluster.sync();
    STAMP(kLinearize);

    // 2. the slots' sums, damped and pinned: a frame's rows, the
    // landmarks (with their inverses), the pairs
    for (int item = gt; item < n + L + n_pq; item += G) {
      if (item < n) {
        const int f = item / 6, i = item % 6;
        float s[7];
        seg_sums<7, 4>(a.perm_f, nullptr, (int)a.f_start[f], (int)a.f_start[f + 1], chunk,
                       [&](int row, float* v) {
                         const float* x = lin + kLin * row;
                         const float wi = x[3 + i] * x[2], wi2 = x[9 + i] * x[2];
#pragma unroll
                         for (int j = 0; j < 6; ++j) v[j] = wi * x[3 + j] + wi2 * x[9 + j];
                         v[6] = x[3 + i] * (x[0] * x[2]) + x[9 + i] * (x[1] * x[2]);
                       }, s);
        for (int j = 0; j < 6; ++j) {
          float h = s[j];
          if (i == j) {
            const float d = h < 1e-8f ? 1e-8f : h;
            h = h + lam * d + (a.fixed[f] ? 1.0f : 0.0f);
          }
          hpp[36 * f + 6 * i + j] = h;
        }
        bp[6 * f + i] = s[6];
      } else if (item < n + L) {
        const int l = item - n;
        float s[12], h[9];
        seg_sums<12, 2>(a.perm_l, row_l, (int)a.l_start[l], (int)a.l_start[l + 1], chunk,
                        [&](int row, float* v) {
                          const float* x = lin + kLin * row;
#pragma unroll
                          for (int i = 0; i < 3; ++i) {
                            const float wi = x[15 + i] * x[2], wi2 = x[18 + i] * x[2];
#pragma unroll
                            for (int j = 0; j < 3; ++j)
                              v[3 * i + j] = wi * x[15 + j] + wi2 * x[18 + j];
                            v[9 + i] = x[15 + i] * (x[0] * x[2]) + x[18 + i] * (x[1] * x[2]);
                          }
                        }, s);
        for (int e = 0; e < 9; ++e) {
          h[e] = s[e];
          if (e % 4 == 0) {  // the diagonal
            const float d = h[e] < 1e-8f ? 1e-8f : h[e];
            h[e] = h[e] + lam * d + (has_obs[l] ? 0.0f : 1.0f);
          }
          hll[9 * l + e] = h[e];
        }
        for (int i = 0; i < 3; ++i) bl[3 * l + i] = s[9 + i];
        inv_info[l] = inv3(h, hinv + 9 * l);
      } else {
        const int q = item - n - L, p = pair_of[q];
        if (p < 0) continue;
        seg_sums<18, 1>(a.perm_p, row_p, q, (int)a.p_start[p + 1], chunk, [&](int row, float* v) {
          const float* x = lin + kLin * row;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
            const float wi = x[3 + i] * x[2], wi2 = x[9 + i] * x[2];
#pragma unroll
            for (int j = 0; j < 3; ++j) v[3 * i + j] = wi * x[15 + j] + wi2 * x[18 + j];
          }
        }, A + ((p % F) * L + p / F) * 18);
      }
    }
    cluster.sync();
    STAMP(kSlots);

    // 3. T = A Hll^-1 for each pair
    for (int item = gt; item < n_pq * 6; item += G) {
      const int q = item / 6, i = item % 6, p = pair_of[q];
      if (p < 0) continue;
      const int l = p / F, at = ((p % F) * L + l) * 18 + 3 * i;
      const float* ap = A + at;
      const float* hi = hinv + 9 * l;
      for (int k = 0; k < 3; ++k)
        T[at + k] = ap[0] * hi[k] + ap[1] * hi[3 + k] + ap[2] * hi[6 + k];
    }
    if (rank == 0 && tid == 0) ctrl->fail = 0;
    cluster.sync();
    STAMP(kInverses);

    // 4. the reduced system into rank 0, a warp a row
    schur_blocks(gw, GW, n, F, L, list_l, list_n, pos, T, A, bl, hpp, bp, S0, rhs0);
    cluster.sync();
    STAMP(kSchur);

    // 5. rank 0: Cholesky (a pivot that is not positive fails it), the
    // solves, and the step's check: bad if the factorisation or an inverse
    // failed or the step is not finite
    if (rank == 0) {
      factor(S, diag, n, ctrl);
      __syncthreads();
      STAMP(kFactor);
      const bool failed = ctrl->fail != 0;
      if (!failed && warp == 0) {
        EVO_DISPATCH8((n + 31) >> 5, solves, S, diag, rhs, n);
      }
      __syncthreads();
      int bad = tid == 0 && failed;
      for (int l = tid; l < L && !failed; l += nt) bad |= inv_info[l] != 0;
      for (int r = tid; r < n && !failed; r += nt) bad |= !vo::finite(rhs[r]);
      bad = __syncthreads_or(bad);
      if (tid == 0) ctrl->bad = bad;
    }
    cluster.sync();
    STAMP(kSolves);

    // 6. the step: the landmarks back-substituted (over their frames in
    // index order), the free poses retracted, into the candidate's buffer
    const bool bad = ctrl0->bad != 0;
    for (int r = tid; r < n; r += nt) dp[r] = bad ? 0.0f : rhs0[r];
    __syncthreads();
    for (int item = gt; item < L + F; item += G) {
      if (item < L) {
        const int l = item;
        float alp[3] = {0.0f, 0.0f, 0.0f};
        for (int f = 0; f < F; ++f) {
          if (pos[l * F + f] < 0) continue;
          const float* ap = A + (f * L + l) * 18;
          const float* d = dp + 6 * f;
          for (int i = 0; i < 6; ++i)
            for (int j = 0; j < 3; ++j) alp[j] = alp[j] + ap[3 * i + j] * d[i];
        }
        float rb[3];
        for (int j = 0; j < 3; ++j) rb[j] = bl[3 * l + j] + alp[j];
        const float* hi = hinv + 9 * l;
        for (int k = 0; k < 3; ++k) {
          float dl = -(hi[3 * k] * rb[0] + hi[3 * k + 1] * rb[1] + hi[3 * k + 2] * rb[2]);
          if (bad || !has_obs[l]) dl = 0.0f;
          lms_c[3 * l + k] = lms[3 * l + k] + dl;
        }
      } else {
        const int f = item - L;
        if (a.fixed[f]) {
          for (int k = 0; k < 7; ++k) poses_c[7 * f + k] = poses[7 * f + k];
        } else {
          vo::se3_retract(poses + 7 * f, dp + 6 * f, poses_c + 7 * f);
        }
      }
    }
    cluster.sync();
    STAMP(kStep);

    // 7. the candidate's cost
    costs(a, poses_c, lms_c, rho, rho32, gt, G);
    cluster.sync();
    STAMP(kCost);
    if (rank == 0 && warp == 0) {
      const double c = warp_sum(rho, O);
      const float c32 = warp_sum(rho32, O);
      // 8. accept, stop, damping (`vo.ba.decide`): on the float64 costs, and
      // a state whose float32 cost is zero is final
      if (lane == 0) {
        const double cost = ctrl->cost;
        const bool accept = isfinite(c) && c < cost && ctrl->cost32 > 0.0f && !bad;
        const double floor = cost < 1e-12 ? 1e-12 : cost;
        const double rel = (cost - c) / floor;
        ctrl->done = ((accept && rel < a.tol) || lam > 1e6f) ? 1 : 0;
        float lam_next = accept ? lam * 0.5f : lam * 4.0f;
        lam_next = lam_next < 1e-10f ? 1e-10f : (lam_next > 1e8f ? 1e8f : lam_next);
        ctrl->lam = lam_next;
        if (accept) {
          ctrl->cost = c;
          ctrl->cost32 = c32;
          ctrl->cur = 1 - cur;
        }
      }
    }
    ++it;
    cluster.sync();
    STAMP(kDecide);
    if (ctrl0->done) break;
  }
  // the accepted state into the result, if it lies in the other buffer
  if (ctrl0->cur == 1) {
    for (int i = gt; i < F * 7; i += G) a.poses[i] = buf_p[1][i];
    for (int i = gt; i < L * 3; i += G) a.lms[i] = buf_l[1][i];
  }
  if (rank == 0 && tid == 0) {
    a.costs[0] = (float)ctrl->cost;
    a.iters[0] = it;
  }
  CLOCK_OUT(a.clocks);
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// the last launch configuration found placeable (one check a shape)
std::mutex placed_lock;
size_t placed_smem = 0;
int placed_threads = 0, placed_cluster = 0;

}  // namespace

// The largest block the build takes (EVO_BA_MAX_THREADS).
extern "C" int evo_ba_max_threads() { return EVO_BA_MAX_THREADS; }

// The scratch's sizes for F frames, L landmarks and O observations: floats
// and ints.
extern "C" void evo_ba_scratch(int F, int L, int O, int* n_float, int* n_int) {
  const Layout lay(F, L, O);
  *n_float = lay.n_float;
  *n_int = lay.n_int;
}

// The launch: one cluster of `cluster` blocks (1 to 16) of `threads` threads
// on `stream`, after a check that such a cluster can be placed; `clocks`
// [kStages] the clock build's cycles by stage (ignored by the plain build).
// Returns the CUDA error of the launch (0: launched).
extern "C" int evo_ba_solve(const float* poses_in, const float* lms_in, const float* intr,
                            const int64_t* of, const int64_t* ol, const float* p2d,
                            const uint8_t* mask, const uint8_t* fixed, const int64_t* perm_f,
                            const int64_t* f_start, const int64_t* perm_l,
                            const int64_t* l_start, const int64_t* perm_p,
                            const int64_t* p_start, int F, int L, int O, int num_iters,
                            int compensated, double huber, double two_huber, double huber_sq,
                            double tol, float* fs, int* is, float* poses, float* lms,
                            float* costs, int* iters, long long* clocks, int threads,
                            int cluster, cudaStream_t stream) {
  if (F < 1 || F > kMaxFrames || cluster < 1 || cluster > kMaxCluster || threads < 64 ||
      threads > EVO_BA_MAX_THREADS || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int n = 6 * F;
  // shared: the control, S, rhs, diag, dp, and the pairs' table where it fits
  size_t smem = sizeof(float) * ((size_t)kCtrl + (size_t)n * n + 3 * (size_t)n);
  const size_t table = sizeof(int) * (size_t)L * F;
  const int pos_shared = smem + table <= kSmemMax ? 1 : 0;
  if (pos_shared) smem += table;
  const Args args{poses_in, lms_in, intr, of, ol, p2d, mask, fixed, perm_f, f_start, perm_l,
                  l_start, perm_p, p_start, F, L, O, num_iters, compensated, pos_shared, huber,
                  two_huber, huber_sq, tol, fs, is, poses, lms, costs, iters, clocks};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  {
    std::lock_guard<std::mutex> hold(placed_lock);
    if (smem != placed_smem || threads != placed_threads || cluster != placed_cluster) {
      cudaError_t err = cudaFuncSetAttribute(
          ba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err == cudaSuccess && cluster > 8)
        err = cudaFuncSetAttribute(ba_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      int placeable = 0;
      if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&placeable, ba_kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (placeable < 1) return (int)cudaErrorInvalidConfiguration;
      placed_smem = smem;
      placed_threads = threads;
      placed_cluster = cluster;
    }
    // launched under the lock: another shape's call could lower the
    // shared memory attribute between the check and the launch
    const cudaError_t err = cudaLaunchKernelEx(&cfg, ba_kernel, args);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
