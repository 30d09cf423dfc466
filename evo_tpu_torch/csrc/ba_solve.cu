// VO's windowed bundle adjustment as one CUDA kernel, one block a call: the
// whole LM loop, up to `num_iters` trips, with no host read until the end.
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
// pivots (126 at F 21). So the design is one block that never leaves the
// SM and runs each stage of a trip wide over its threads:
//  1. a thread an observation: the residual, the Huber weight and the
//     analytic Jacobians (the plain `_obs_linearize` formulas);
//  2. a thread an entry of a slot's sum (Hpp, bp by frame; Hll, bl by
//     landmark; A by (landmark, frame) pair), summed serially over the
//     slot's observations in the order the caller gives (`SegmentSum`'s: by
//     slot, then (landmark, frame), then index, masked observations left
//     out), or, with `compensated`, in `compensated_scatter_add`'s: the rows
//     by slot and index, in chunks of ceil(O / 32) rows, the chunks' partial
//     sums added by a two-float sum; the damping and the pins go in as the
//     entry is written;
//  3. a thread a landmark: the 3x3 inverse with LU's failure flag;
//  4. the Schur reduction S = Hpp - sum_l T_lf A_lg^T, T = A Hll^-1, into
//     shared memory (126 x 126 floats, 63.5 KB, opted in above 48 KB), an
//     entry a thread summed over the landmarks in index order, only the
//     lower triangle that the factorisation reads;
//  5. the Cholesky of S and the two triangular solves, a pivot at a time
//     with the block updating the trailing triangle;
//  6. landmark back-substitution and `se3_retract` of the free poses;
//  7. the candidate's Huber cost in float64 (a residual is a difference of
//     pixel coordinates of ~100 px, so a float32 cost is good to ~1e-6 of
//     itself while the stop test weighs decreases of tol, 1e-5, of it) and
//     in float32, each summed by warp 0 in a fixed order;
//  8. one thread: accept and stop on the float64 costs, a zero float32 cost
//     final (`vo.ba.decide`), the damping's update.
// The (landmark, frame) pairs are a dense [L][F] grid; an empty pair's
// segment is empty. No atomics, no sum whose order depends on the block's
// size: the same inputs give the same bits on every run and at any block
// size.
//
// Built with -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vo_geometry.cuh"

namespace {

constexpr int kChunks = 32;  // compensated_scatter_add's n_chunks
constexpr int kLin = 21;     // an observation's r [2], w, Jp [2][6], Jl [2][3]

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
  double huber, two_huber, huber_sq, tol;
  float* fs;      // float scratch (`Layout`)
  int* is;        // int scratch (`Layout`)
  float* poses;   // [F][7]: the accepted poses, the result
  float* lms;     // [L][3]: the accepted landmarks, the result
  float* costs;   // [2]: cost, cost0
  int* iters;     // [1]
};

// offsets into the scratch, in floats; the float64 `rho` first, so that it
// lies on the scratch's 8-byte alignment
struct Layout {
  int rho, rho32, lin, hpp, bp, hll, bl, hinv, a, t, dp, poses_new, lms_new, n_float;
  // ints
  int has_obs, inv_info, n_int;
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
    a = x; x += L * F * 18;
    t = x; x += L * F * 18;
    dp = x; x += F * 6;
    poses_new = x; x += F * 7;
    lms_new = x; x += L * 3;
    n_float = x;
    x = 0;
    has_obs = x; x += L;
    inv_info = x; x += L;
    n_int = x;
  }
};

__device__ __forceinline__ void two_sum(float& hi, float& lo, float x) {
  const float s = hi + x;
  const float bp = s - hi;
  const float err = (hi - (s - bp)) + (x - bp);
  hi = s;
  lo = lo + err;
}

// the sum of value(o) over the observations perm[begin:end]: in that order,
// or with `chunk` > 0 the partial sums of each chunk of `chunk` rows (by
// index) added by a two-float sum and folded
template <class V>
__device__ float seg_sum(const int64_t* perm, int begin, int end, int chunk, V value) {
  float part = 0.0f;
  if (chunk == 0) {
    for (int q = begin; q < end; ++q) part = part + value((int)perm[q]);
    return part;
  }
  float hi = 0.0f, lo = 0.0f;
  int cur = -1;
  for (int q = begin; q < end; ++q) {
    const int o = (int)perm[q];
    const int k = o / chunk;
    if (k != cur) {
      if (cur >= 0) two_sum(hi, lo, part);
      part = 0.0f;
      cur = k;
    }
    part = part + value(o);
  }
  if (cur >= 0) two_sum(hi, lo, part);
  return hi + lo;
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

// the sum of x[0:O] by warp 0: lane j adds rows j, j + 32, ... in order,
// then the lanes' sums in a fixed tree; the result on every lane of warp 0
template <class T>
__device__ T warp_sum(const T* x, int O) {
  const int lane = threadIdx.x & 31;
  T s = 0;
  for (int o = lane; o < O; o += 32) s = s + x[o];
  for (int d = 16; d > 0; d >>= 1) s = s + __shfl_xor_sync(0xffffffffu, s, d);
  return s;
}

// each observation's rho in float64 and float32
__device__ void costs(const Args& a, const float* poses, const float* lms, double* rho,
                      float* rho32) {
  for (int o = threadIdx.x; o < a.O; o += blockDim.x) {
    const float* pose = poses + 7 * a.of[o];
    const float* lm = lms + 3 * a.ol[o];
    rho[o] = robust_rho<double>(a, o, pose, lm);
    rho32[o] = robust_rho<float>(a, o, pose, lm);
  }
}

__global__ void __launch_bounds__(512) ba_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int F = a.F, L = a.L, O = a.O, n = 6 * F;
  float* S = smem;        // [n][n], the lower triangle
  float* rhs = S + n * n;  // [n]: -v, then the step
  float* diag = rhs + n;   // [n]: the factor's diagonal
  const Layout lay(F, L, O);
  double* rho = reinterpret_cast<double*>(a.fs + lay.rho);
  float* rho32 = a.fs + lay.rho32;
  float* lin = a.fs + lay.lin;
  float* hpp = a.fs + lay.hpp;
  float* bp = a.fs + lay.bp;
  float* hll = a.fs + lay.hll;
  float* bl = a.fs + lay.bl;
  float* hinv = a.fs + lay.hinv;
  float* A = a.fs + lay.a;  // [L][F][6][3]
  float* T = a.fs + lay.t;  // [L][F][6][3]
  float* dp = a.fs + lay.dp;
  float* poses_new = a.fs + lay.poses_new;
  float* lms_new = a.fs + lay.lms_new;
  int* has_obs = a.is + lay.has_obs;
  int* inv_info = a.is + lay.inv_info;
  __shared__ int done_s, fail_s, bad_s, accept_s;
  __shared__ float lam_s;
  __shared__ double cost_s;
  __shared__ float cost32_s;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int chunk = a.compensated ? (O + kChunks - 1) / kChunks : 0;
  // whether the (landmark, frame) pair p has an observation in the sums
  auto paired = [&](int p) { return a.p_start[p + 1] > a.p_start[p]; };

  // -- once a launch: the state, the landmarks with an observation that
  // counts, the initial cost
  for (int i = tid; i < F * 7; i += nt) a.poses[i] = a.poses_in[i];
  for (int i = tid; i < L * 3; i += nt) a.lms[i] = a.lms_in[i];
  for (int l = tid; l < L; l += nt) {
    int any = 0;
    for (int64_t q = a.l_start[l]; q < a.l_start[l + 1]; ++q) any |= a.mask[a.perm_l[q]] ? 1 : 0;
    has_obs[l] = any;
  }
  if (tid == 0) {
    lam_s = 1e-4f;
    done_s = 0;
  }
  costs(a, a.poses_in, a.lms_in, rho, rho32);
  __syncthreads();
  if (tid < 32) {
    const double c = warp_sum(rho, O);
    const float c32 = warp_sum(rho32, O);
    if (tid == 0) {
      cost_s = c;
      cost32_s = c32;
      a.costs[1] = (float)c;
    }
  }
  __syncthreads();

  int it = 0;
  while (it < a.num_iters) {
    const float lam = lam_s;
    // 1. linearize every observation at the accepted state
    for (int o = tid; o < O; o += nt)
      linearize_obs(a, o, a.poses + 7 * a.of[o], a.lms + 3 * a.ol[o], lin + kLin * o);
    __syncthreads();

    // 2. the slots' sums, damped and pinned
    const int n_frame = F * 42, n_lm = L * 12, n_items = n_frame + n_lm + L * F * 18;
    for (int item = tid; item < n_items; item += nt) {
      if (item < n_frame) {
        const int f = item / 42, e = item % 42;
        const int b0 = (int)a.f_start[f], b1 = (int)a.f_start[f + 1];
        if (e < 36) {
          const int i = e / 6, j = e % 6;
          float s = seg_sum(a.perm_f, b0, b1, chunk, [&](int o) {
            const float* x = lin + kLin * o;
            return (x[3 + i] * x[2]) * x[3 + j] + (x[9 + i] * x[2]) * x[9 + j];
          });
          if (i == j) {
            const float d = s < 1e-8f ? 1e-8f : s;
            s = s + lam * d + (a.fixed[f] ? 1.0f : 0.0f);
          }
          hpp[36 * f + e] = s;
        } else {
          const int i = e - 36;
          bp[6 * f + i] = seg_sum(a.perm_f, b0, b1, chunk, [&](int o) {
            const float* x = lin + kLin * o;
            return x[3 + i] * (x[0] * x[2]) + x[9 + i] * (x[1] * x[2]);
          });
        }
      } else if (item < n_frame + n_lm) {
        const int l = (item - n_frame) / 12, e = (item - n_frame) % 12;
        const int b0 = (int)a.l_start[l], b1 = (int)a.l_start[l + 1];
        if (e < 9) {
          const int i = e / 3, j = e % 3;
          float s = seg_sum(a.perm_l, b0, b1, chunk, [&](int o) {
            const float* x = lin + kLin * o;
            return (x[15 + i] * x[2]) * x[15 + j] + (x[18 + i] * x[2]) * x[18 + j];
          });
          if (i == j) {
            const float d = s < 1e-8f ? 1e-8f : s;
            s = s + lam * d + (has_obs[l] ? 0.0f : 1.0f);
          }
          hll[9 * l + e] = s;
        } else {
          const int i = e - 9;
          bl[3 * l + i] = seg_sum(a.perm_l, b0, b1, chunk, [&](int o) {
            const float* x = lin + kLin * o;
            return x[15 + i] * (x[0] * x[2]) + x[18 + i] * (x[1] * x[2]);
          });
        }
      } else {
        const int p = (item - n_frame - n_lm) / 18, e = (item - n_frame - n_lm) % 18;
        const int i = e / 3, j = e % 3;
        A[18 * p + e] = seg_sum(a.perm_p, (int)a.p_start[p], (int)a.p_start[p + 1], chunk,
                                [&](int o) {
                                  const float* x = lin + kLin * o;
                                  return (x[3 + i] * x[2]) * x[15 + j] +
                                         (x[9 + i] * x[2]) * x[18 + j];
                                });
      }
    }
    __syncthreads();

    // 3. the landmarks' inverses
    for (int l = tid; l < L; l += nt) inv_info[l] = inv3(hll + 9 * l, hinv + 9 * l);
    __syncthreads();
    // T = A Hll^-1 for each pair
    for (int item = tid; item < L * F * 18; item += nt) {
      const int p = item / 18, e = item % 18, i = e / 3, k = e % 3;
      const float* ap = A + 18 * p + 3 * i;
      const float* hi = hinv + 9 * (p / F);
      T[item] = ap[0] * hi[k] + ap[1] * hi[3 + k] + ap[2] * hi[6 + k];
    }
    __syncthreads();

    // 4. the reduced system: S's lower triangle and -v, each summed over the
    // landmarks that both frames see, in index order
    const int n_tri = n * (n + 1) / 2;
    for (int item = tid; item < n_tri + n; item += nt) {
      if (item < n_tri) {
        // row r >= column c of the packed lower triangle
        int r = (int)((sqrtf(8.0f * item + 1.0f) - 1.0f) * 0.5f);
        while (r * (r + 1) / 2 > item) --r;
        while ((r + 1) * (r + 2) / 2 <= item) ++r;
        const int c = item - r * (r + 1) / 2;
        const int f = r / 6, i = r % 6, g = c / 6, k = c % 6;
        float acc = 0.0f;
        for (int l = 0; l < L; ++l) {
          const int pf = l * F + f, pg = l * F + g;
          if (!paired(pf) || !paired(pg)) continue;
          const float* tr = T + 18 * pf + 3 * i;
          const float* ar = A + 18 * pg + 3 * k;
          acc = acc + (tr[0] * ar[0] + tr[1] * ar[1] + tr[2] * ar[2]);
        }
        float s = -acc;
        if (f == g) s = s + hpp[36 * f + 6 * i + k];
        S[r * n + c] = s;
      } else {
        const int r = item - n_tri, f = r / 6, i = r % 6;
        float acc = 0.0f;
        for (int l = 0; l < L; ++l) {
          const int p = l * F + f;
          if (!paired(p)) continue;
          const float* tr = T + 18 * p + 3 * i;
          const float* b = bl + 3 * l;
          acc = acc + (tr[0] * b[0] + tr[1] * b[1] + tr[2] * b[2]);
        }
        rhs[r] = -(bp[6 * f + i] - acc);
      }
    }
    if (tid == 0) fail_s = 0;
    __syncthreads();

    // 5. Cholesky (a pivot that is not positive fails it), then the solves
    for (int k = 0; k < n; ++k) {
      const float piv = S[k * n + k];
      if (!(piv > 0.0f)) {
        if (tid == 0) fail_s = 1;
        break;
      }
      const float d = sqrtf(piv);
      if (tid == 0) diag[k] = d;
      for (int i = k + 1 + tid; i < n; i += nt) S[i * n + k] = S[i * n + k] / d;
      __syncthreads();
      const int m = n - k - 1;
      for (int item = tid; item < m * (m + 1) / 2; item += nt) {
        int r = (int)((sqrtf(8.0f * item + 1.0f) - 1.0f) * 0.5f);
        while (r * (r + 1) / 2 > item) --r;
        while ((r + 1) * (r + 2) / 2 <= item) ++r;
        const int i = k + 1 + r, j = k + 1 + item - r * (r + 1) / 2;
        S[i * n + j] = S[i * n + j] - S[i * n + k] * S[j * n + k];
      }
      __syncthreads();
    }
    __syncthreads();
    const bool failed = fail_s != 0;
    if (!failed) {
      for (int k = 0; k < n; ++k) {  // L y = -v
        const float y = rhs[k] / diag[k];
        for (int i = k + 1 + tid; i < n; i += nt) rhs[i] = rhs[i] - S[i * n + k] * y;
        __syncthreads();
        if (tid == 0) rhs[k] = y;
        __syncthreads();
      }
      for (int k = n - 1; k >= 0; --k) {  // L^T x = y
        const float x = rhs[k] / diag[k];
        for (int i = tid; i < k; i += nt) rhs[i] = rhs[i] - S[k * n + i] * x;
        __syncthreads();
        if (tid == 0) rhs[k] = x;
        __syncthreads();
      }
    }

    // 6. the step: bad if the factorisation or an inverse failed or the step
    // is not finite; the landmarks back-substituted (over their frames in
    // index order), the free poses retracted
    if (tid == 0) {
      bool bad = failed;
      for (int l = 0; l < L && !bad; ++l) bad = inv_info[l] != 0;
      for (int r = 0; r < n && !bad; ++r) bad = !vo::finite(rhs[r]);
      bad_s = bad;
    }
    __syncthreads();
    const bool bad = bad_s != 0;
    for (int r = tid; r < n; r += nt) dp[r] = bad ? 0.0f : rhs[r];
    __syncthreads();
    for (int item = tid; item < L + F; item += nt) {
      if (item < L) {
        const int l = item;
        float rb[3];
        for (int j = 0; j < 3; ++j) {
          float alp = 0.0f;
          for (int f = 0; f < F; ++f) {
            if (!paired(l * F + f)) continue;
            const float* ap = A + 18 * (l * F + f);
            const float* d = dp + 6 * f;
            for (int i = 0; i < 6; ++i) alp = alp + ap[3 * i + j] * d[i];
          }
          rb[j] = bl[3 * l + j] + alp;
        }
        const float* hi = hinv + 9 * l;
        for (int k = 0; k < 3; ++k) {
          float dl = -(hi[3 * k] * rb[0] + hi[3 * k + 1] * rb[1] + hi[3 * k + 2] * rb[2]);
          if (bad || !has_obs[l]) dl = 0.0f;
          lms_new[3 * l + k] = a.lms[3 * l + k] + dl;
        }
      } else {
        const int f = item - L;
        if (a.fixed[f]) {
          for (int k = 0; k < 7; ++k) poses_new[7 * f + k] = a.poses[7 * f + k];
        } else {
          vo::se3_retract(a.poses + 7 * f, dp + 6 * f, poses_new + 7 * f);
        }
      }
    }
    __syncthreads();

    // 7. the candidate's cost
    costs(a, poses_new, lms_new, rho, rho32);
    __syncthreads();
    if (tid < 32) {
      const double c = warp_sum(rho, O);
      const float c32 = warp_sum(rho32, O);
      // 8. accept, stop, damping (`vo.ba.decide`): on the float64 costs, and
      // a state whose float32 cost is zero is final
      if (tid == 0) {
        const double cost = cost_s;
        const bool accept = isfinite(c) && c < cost && cost32_s > 0.0f && !bad;
        const double floor = cost < 1e-12 ? 1e-12 : cost;
        const double rel = (cost - c) / floor;
        done_s = ((accept && rel < a.tol) || lam > 1e6f) ? 1 : 0;
        accept_s = accept;
        float lam_next = accept ? lam * 0.5f : lam * 4.0f;
        lam_next = lam_next < 1e-10f ? 1e-10f : (lam_next > 1e8f ? 1e8f : lam_next);
        lam_s = lam_next;
        if (accept) {
          cost_s = c;
          cost32_s = c32;
        }
      }
    }
    __syncthreads();
    if (accept_s) {
      for (int i = tid; i < F * 7; i += nt) a.poses[i] = poses_new[i];
      for (int i = tid; i < L * 3; i += nt) a.lms[i] = lms_new[i];
    }
    ++it;
    __syncthreads();
    if (done_s) break;
  }
  if (tid == 0) {
    a.costs[0] = (float)cost_s;
    a.iters[0] = it;
  }
}

}  // namespace

// The scratch's sizes for F frames, L landmarks and O observations: floats
// and ints.
extern "C" void evo_ba_scratch(int F, int L, int O, int* n_float, int* n_int) {
  const Layout lay(F, L, O);
  *n_float = lay.n_float;
  *n_int = lay.n_int;
}

// The launch: one block of `threads` threads on `stream`. Returns the CUDA
// error of the launch (0: launched).
extern "C" int evo_ba_solve(const float* poses_in, const float* lms_in, const float* intr,
                            const int64_t* of, const int64_t* ol, const float* p2d,
                            const uint8_t* mask, const uint8_t* fixed, const int64_t* perm_f,
                            const int64_t* f_start, const int64_t* perm_l,
                            const int64_t* l_start, const int64_t* perm_p,
                            const int64_t* p_start, int F, int L, int O, int num_iters,
                            int compensated, double huber, double two_huber, double huber_sq,
                            double tol, float* fs, int* is, float* poses, float* lms,
                            float* costs, int* iters, int threads, cudaStream_t stream) {
  const Args args{poses_in, lms_in, intr, of, ol, p2d, mask, fixed, perm_f, f_start, perm_l,
                  l_start, perm_p, p_start, F, L, O, num_iters, compensated, huber,
                  two_huber, huber_sq, tol, fs, is, poses, lms, costs, iters};
  const size_t smem = sizeof(float) * ((size_t)36 * F * F + 12 * (size_t)F);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ba_kernel<<<1, threads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}
