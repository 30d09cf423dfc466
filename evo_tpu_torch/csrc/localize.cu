// VO's 2D-3D localization as one CUDA kernel, one block a call: unproject,
// P3P RANSAC over given minimal samples, LM refinement on the inliers and
// the inliers' reselection.
//
// Replaces `evo_tpu/solve/ransac.py::localize_camera_fused` (:223), one
// jitted XLA program in the JAX package (no Pallas kernel): its P3P
// (`evo_tpu/solve/p3p.py::p3p_grunert`, `_quartic_real_roots`, `_kabsch_3pt`,
// `reprojection_angle_residual`), the first-of-the-best choice of `ransac`
// and the refinement of `lm_solve` (`evo_tpu/solve/lm.py`). The plain
// PyTorch version is `evo_tpu_torch/solve/ransac.py::localize_camera_fused_ref`.
//
// What bounds it: neither bytes (a few KB in and out) nor operations (about
// 2 MFLOP at 128 hypotheses and N 128) but the chains of dependent steps:
// the 24 bisections and 6 Newton steps of each quartic, and the LM's 10
// trips of a 6x6 solve in series. Everything stays in one block. The first
// design's clock split (N 128, H 128) put 27 % of a launch in the
// candidates' scores (a thread a candidate, half of them invalid), 20 % in
// P3P (a thread a hypothesis: 128 of 512 threads, each its 256-point grid
// and four roots in series), 18 % in each of the LM's normal equations and
// its one-thread steps, 10 % in a one-thread scan for the best. So:
// (a) a thread a pixel unprojects into shared memory; (b) a warp eight
// hypotheses at a time, lane 4 h + k hypothesis h's root k: the lanes
// evaluate the eight quartics on the grid, a ballot a 32 points, and the
// first four sign changes of each come from the ballots' bits in the serial
// scan's order (with its rule for an interval 0 that has no change); each
// root's 24 bisections and 6 Newton steps, its Kabsch and its pose run in
// its lane; (c) a warp a valid candidate, its lanes over a list of the
// valid points (made by warp 0 in (b)), the count a sum of `__popc` of
// ballots; (d) the first candidate with the most
// inliers by a block reduction (the larger count, then the smaller index);
// (e) the LM, each trip a thread a point for the residual and its
// closed-form Jacobian, one thread an entry for J^T J, J^T r and the cost
// (summed over the points in index order), one thread for the accept and
// the next trip's solve (three barriers a trip); (f) a thread a point
// reselects. Every evaluation, root, count and sum keeps the first design's
// operations and order, so it gives that design's bits. No atomics: the
// result does not depend on the block's size or on what runs beside it.
//
// The quartic's grid comes in from the caller (`torch.linspace` on the
// tensors' device, as the plain version builds it), so both see one grid.
// Built with -fmad=false.
//
// The clock build (-DEVO_LOC_CLOCKS, a library of its own) writes the cycles
// of each stage into `clocks` (`Stage`, `kernels.localize.STAGES`; the LM's
// parts summed over its trips); the plain build ignores the pointer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "vo_geometry.cuh"

namespace {

constexpr int kGrid = 256;
constexpr float kVMax = 16.0f;
constexpr int kBisect = 24;
constexpr int kNewton = 6;
constexpr int kLmIters = 10;

// Stage clock (-DEVO_LOC_CLOCKS only): thread 0 adds the clock64() cycles
// since the previous mark into a stage's bin; each MARK comes after a
// barrier of its own, so a stage's time is its slowest thread's, and the
// stages add up to the total.
enum Stage { kUnproject, kP3p, kScore, kSelect, kLmLinearize, kLmNormal, kLmSolve, kReselect,
             kTotal, kStages };
#ifdef EVO_LOC_CLOCKS
struct Clock {
  long long last, start, bins[kStages];
};
__device__ void stamp(Clock& clk, int stage) {
  if (threadIdx.x == 0) {
    const long long t = clock64();
    clk.bins[stage] += t - clk.last;
    clk.last = t;
  }
}
#define CLOCK_DECL() __shared__ Clock clk
#define CLOCK_START()                                      \
  if (threadIdx.x == 0) {                                  \
    clk.start = clk.last = clock64();                      \
    for (int k = 0; k < kStages; ++k) clk.bins[k] = 0;     \
  }
#define MARK(stage) (__syncthreads(), stamp(clk, stage))
#define CLOCK_OUT(out)                                                  \
  if (threadIdx.x == 0 && (out) != nullptr) {                           \
    clk.bins[kTotal] = clk.last - clk.start;                            \
    for (int k = 0; k < kStages; ++k) (out)[k] = clk.bins[k];           \
  }
#else
#define CLOCK_DECL()
#define CLOCK_START()
#define MARK(stage) ((void)0)
#define CLOCK_OUT(out)
#endif

constexpr unsigned kFull = 0xffffffffu;

// the quartic and its derivative (`_quartic_real_roots`' polynomials)
__device__ __forceinline__ float quartic(const float* A, float v) {
  return (((A[0] * v + A[1]) * v + A[2]) * v + A[3]) * v + A[4];
}
__device__ __forceinline__ float quartic_d(const float* A, float v) {
  return ((4.0f * A[0] * v + 3.0f * A[1]) * v + 2.0f * A[2]) * v + A[3];
}

// one real root of the quartic in (0, 16], as `_quartic_real_roots` finds
// its k-th: 24 bisections of the grid's interval i (the k-th sign change of
// the grid's values; none: interval 0, whose own change, or not, says
// whether the root is had: `have`), then 6 Newton steps
__device__ void quartic_root(const float* A, const float* grid, int i, bool have, float* root_out,
                             bool* valid) {
  float lo = grid[i], hi = grid[i + 1];
  for (int it = 0; it < kBisect; ++it) {
    const float mid = 0.5f * (lo + hi);
    const bool same = signbit(quartic(A, mid)) == signbit(quartic(A, lo));
    lo = same ? mid : lo;
    hi = same ? hi : mid;
  }
  float root = 0.5f * (lo + hi);
  for (int it = 0; it < kNewton; ++it) {
    const float d = quartic_d(A, root);
    const float step = quartic(A, root) / (fabsf(d) < 1e-12f ? 1e-12f : d);
    const float r2 = root - step;
    if (r2 > 0.0f && r2 <= kVMax && vo::finite(r2)) root = r2;
  }
  *root_out = root;
  *valid = have && root > 0.0f && vo::finite(root);
}

// orthonormal columns of the triad of three points (`_kabsch_3pt`'s triad),
// row major
__device__ void triad(const float* p0, const float* p1, const float* p2, float* M) {
  float u1[3], v[3], u2[3], u3[3];
  for (int i = 0; i < 3; ++i) u1[i] = p1[i] - p0[i];
  float n = vo::norm3(u1);
  n = n < 1e-12f ? 1e-12f : n;
  for (int i = 0; i < 3; ++i) u1[i] = u1[i] / n;
  for (int i = 0; i < 3; ++i) v[i] = p2[i] - p0[i];
  const float d = vo::dot3(v, u1);
  for (int i = 0; i < 3; ++i) v[i] = v[i] - d * u1[i];
  n = vo::norm3(v);
  n = n < 1e-12f ? 1e-12f : n;
  for (int i = 0; i < 3; ++i) u2[i] = v[i] / n;
  vo::cross3(u1, u2, u3);
  for (int i = 0; i < 3; ++i) {
    M[3 * i + 0] = u1[i];
    M[3 * i + 1] = u2[i];
    M[3 * i + 2] = u3[i];
  }
}

// x with J x = r by Cramer's rule, J row major (`_solve3_cramer`)
__device__ void solve3_cramer(const float* J, const float* r, float* x) {
  const float c0[3] = {J[0], J[3], J[6]}, c1[3] = {J[1], J[4], J[7]}, c2[3] = {J[2], J[5], J[8]};
  float t[3];
  vo::cross3(c1, c2, t);
  float det = vo::dot3(c0, t);
  det = fabsf(det) < 1e-12f ? 1e-12f : det;
  const float x0 = vo::dot3(r, t);
  vo::cross3(r, c2, t);
  const float x1 = vo::dot3(c0, t);
  vo::cross3(c1, r, t);
  const float x2 = vo::dot3(c0, t);
  x[0] = x0 / det;
  x[1] = x1 / det;
  x[2] = x2 / det;
}

// Grunert's P3P (`p3p_grunert`) of one minimal sample, bearings j[3][3] and
// world points P[3][3] (a row each): its quartic's coefficients and what
// each root's pose needs
struct P3p {
  float A[5], scale, b2, ca, cb, cg, amc, a2s, b2ss, c2s;
};
__device__ void p3p_setup(const float (*j)[3], const float (*P)[3], P3p& out) {
  float d[3];
  for (int i = 0; i < 3; ++i) d[i] = P[1][i] - P[2][i];
  float a2 = vo::dot3(d, d);
  for (int i = 0; i < 3; ++i) d[i] = P[0][i] - P[2][i];
  float b2 = vo::dot3(d, d);
  for (int i = 0; i < 3; ++i) d[i] = P[0][i] - P[1][i];
  float c2 = vo::dot3(d, d);
  float scale2 = (a2 + b2 + c2) / 3.0f;
  scale2 = scale2 < 1e-12f ? 1e-12f : scale2;
  const float scale = sqrtf(scale2);
  a2 = a2 / scale2;
  b2 = b2 / scale2;
  c2 = c2 / scale2;
  const float ca = vo::dot3(j[1], j[2]), cb = vo::dot3(j[0], j[2]), cg = vo::dot3(j[0], j[1]);
  const float b2s = b2 < 1e-12f ? 1e-12f : b2;
  const float amc = (a2 - c2) / b2s, apc = (a2 + c2) / b2s;
  const float bmc = (b2 - c2) / b2s, bma = (b2 - a2) / b2s;
  float A[5];
  A[0] = (amc - 1.0f) * (amc - 1.0f) - 4.0f * (c2 / b2s) * ca * ca;
  A[1] = 4.0f * (amc * (1.0f - amc) * cb - (1.0f - apc) * ca * cg
                 + 2.0f * (c2 / b2s) * ca * ca * cb);
  A[2] = 2.0f * (amc * amc - 1.0f + 2.0f * amc * amc * cb * cb + 2.0f * bmc * ca * ca
                 - 4.0f * apc * ca * cb * cg + 2.0f * bma * cg * cg);
  A[3] = 4.0f * (-amc * (1.0f + amc) * cb + 2.0f * (a2 / b2s) * cg * cg * cb
                 - (1.0f - apc) * ca * cg);
  A[4] = (1.0f + amc) * (1.0f + amc) - 4.0f * (a2 / b2s) * cg * cg;
  for (int e = 0; e < 5; ++e) out.A[e] = A[e];
  out.scale = scale;
  out.b2 = b2;
  out.ca = ca;
  out.cb = cb;
  out.cg = cg;
  out.amc = amc;
  out.a2s = a2 * scale2;
  out.b2ss = b2 * scale2;
  out.c2s = c2 * scale2;
}

// the pose T_w_c of one root v of the sample's quartic (valid: `v_valid`),
// and whether it is one: `p3p_grunert`'s back-substitution, Newton polish
// and Kabsch
__device__ void p3p_pose(const float (*j)[3], const float (*P)[3], const P3p& st, float v,
                         bool v_valid, float* pose, bool* valid) {
  const float scale = st.scale, b2 = st.b2, ca = st.ca, cb = st.cb, cg = st.cg, amc = st.amc;
  const float a2s = st.a2s, b2ss = st.b2ss, c2s = st.c2s;
  {
    float denom = 2.0f * (cg - v * ca);
    denom = fabsf(denom) < 1e-9f ? 1e-9f : denom;
    const float u = ((-1.0f + amc) * v * v - 2.0f * amc * cb * v + 1.0f + amc) / denom;
    float q = 1.0f + v * v - 2.0f * v * cb;
    q = q < 1e-12f ? 1e-12f : q;
    const float s1 = sqrtf(b2 / q) * scale;
    float s[3] = {s1, u * s1, v * s1};
    const bool dist_valid = v_valid && s[0] > 0.0f && s[1] > 0.0f && s[2] > 0.0f;
    // Newton polish on the three laws of cosines
    for (int it = 0; it < 3; ++it) {
      const float t1 = s[0], t2 = s[1], t3 = s[2];
      const float r[3] = {t2 * t2 + t3 * t3 - 2.0f * t2 * t3 * ca - a2s,
                          t1 * t1 + t3 * t3 - 2.0f * t1 * t3 * cb - b2ss,
                          t1 * t1 + t2 * t2 - 2.0f * t1 * t2 * cg - c2s};
      const float J[9] = {0.0f + 1e-9f, 2.0f * t2 - 2.0f * t3 * ca, 2.0f * t3 - 2.0f * t2 * ca,
                          2.0f * t1 - 2.0f * t3 * cb, 0.0f + 1e-9f, 2.0f * t3 - 2.0f * t1 * cb,
                          2.0f * t1 - 2.0f * t2 * cg, 2.0f * t2 - 2.0f * t1 * cg, 0.0f + 1e-9f};
      float x[3];
      solve3_cramer(J, r, x);
      const float sn[3] = {s[0] - x[0], s[1] - x[1], s[2] - x[2]};
      bool ok = true;
      for (int i = 0; i < 3; ++i) ok = ok && vo::finite(sn[i]) && sn[i] > 0.0f;
      if (ok)
        for (int i = 0; i < 3; ++i) s[i] = sn[i];
    }
    // the camera-frame points, the triads' rotation and the centroids
    float pc[3][3];
    for (int p = 0; p < 3; ++p)
      for (int i = 0; i < 3; ++i) pc[p][i] = s[p] * j[p][i];
    float W[9], C[9], R[9];
    triad(P[0], P[1], P[2], W);
    triad(pc[0], pc[1], pc[2], C);
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        R[3 * r + c] = C[3 * r + 0] * W[3 * c + 0] + C[3 * r + 1] * W[3 * c + 1]
                       + C[3 * r + 2] * W[3 * c + 2];
    float cw[3], cc[3], g[7];
    for (int i = 0; i < 3; ++i) {
      cw[i] = (P[0][i] + P[1][i] + P[2][i]) / 3.0f;
      cc[i] = (pc[0][i] + pc[1][i] + pc[2][i]) / 3.0f;
    }
    for (int i = 0; i < 3; ++i) g[4 + i] = cc[i] - vo::dot3(R + 3 * i, cw);
    vo::quat_from_matrix(R, g);
    vo::se3_inverse(g, pose);
    bool fin = true;
    for (int i = 0; i < 7; ++i) fin = fin && vo::finite(pose[i]);
    *valid = dist_valid && fin;
  }
}

// 1 - cos of the angle between the bearing b and the direction of X seen
// from the camera whose inverse pose is `inv` (`reprojection_angle_residual`);
// with `p_out`, the camera-frame point and its norm
__device__ __forceinline__ float angle_residual(const float* inv, const float* b, const float* X,
                                                float* p_out = nullptr, float* n_out = nullptr) {
  float p[3];
  vo::se3_apply(inv, X, p);
  float n = vo::norm3(p);
  n = n < 1e-12f ? 1e-12f : n;
  const float pred[3] = {p[0] / n, p[1] / n, p[2] / n};
  if (p_out) {
    for (int i = 0; i < 3; ++i) p_out[i] = p[i];
    *n_out = n;
  }
  return 1.0f - vo::dot3(b, pred);
}

// `solve_spd` of one 6x6 system (the unrolled Cholesky, pivots clamped at
// 1e-30, NaN kept)
__device__ void solve_spd6(const float* A, const float* b, float* x) {
  float L[6][6], y[6];
  for (int i = 0; i < 6; ++i) {
    float s = A[6 * i + i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * L[i][k];
    L[i][i] = sqrtf(s < 1e-30f ? 1e-30f : s);
    for (int j = i + 1; j < 6; ++j) {
      float t = A[6 * j + i];
      for (int k = 0; k < i; ++k) t = t - L[j][k] * L[i][k];
      L[j][i] = t / L[i][i];
    }
  }
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

struct Sys {
  float A[36], g[6], cost;
};

// one LM trip's step from the current normal equations, damped by lam:
// delta = -(A + lam diag(A))^-1 g (zero and `bad` if it is not finite), and
// the candidate x_new = x exp(delta)
__device__ void lm_step(const Sys& cur, float lam, const float* x, float* x_new, int* bad_out) {
  float M[36], delta[6];
  for (int k = 0; k < 36; ++k) M[k] = cur.A[k];
  for (int d = 0; d < 6; ++d) {
    const float dg = cur.A[7 * d] < 1e-8f ? 1e-8f : cur.A[7 * d];
    M[7 * d] = cur.A[7 * d] + lam * dg;
  }
  solve_spd6(M, cur.g, delta);
  bool bad = false;
  for (int d = 0; d < 6; ++d) {
    delta[d] = -delta[d];
    bad = bad || !vo::finite(delta[d]);
  }
  if (bad)
    for (int d = 0; d < 6; ++d) delta[d] = 0.0f;
  *bad_out = bad;
  vo::se3_retract(x, delta, x_new);
}

// the refinement's linearization at x: each point's weighted residual and
// its Jacobian in the tangent of `se3_retract` at 0, closed form: with p_c
// = exp(-delta) T^-1 X, dp_c/d(v, omega) = [-I | [p_c]x], and d(1 - b.p/|p|)
// /dp = -(b - (b.phat) phat)/|p|. `rj` [n][7]: r, then J.
__device__ void linearize_points(const float* x, const float* b, const float* X, const float* w,
                                 int n, float* rj) {
  const float zero[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float xe[7], inv[7];
  vo::se3_retract(x, zero, xe);  // the point the plain version's forward mode runs at
  vo::se3_inverse(xe, inv);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float p[3], nrm;
    const float r = angle_residual(inv, b + 3 * i, X + 3 * i, p, &nrm);
    const float ph[3] = {p[0] / nrm, p[1] / nrm, p[2] / nrm};
    const float c = vo::dot3(b + 3 * i, ph);
    float g[3], gxp[3];
    for (int k = 0; k < 3; ++k) g[k] = -(b[3 * i + k] - c * ph[k]) / nrm;
    vo::cross3(g, p, gxp);
    float* o = rj + 7 * i;
    o[0] = r * w[i];
    for (int k = 0; k < 3; ++k) o[1 + k] = -g[k] * w[i];
    for (int k = 0; k < 3; ++k) o[4 + k] = gxp[k] * w[i];
  }
}

// J^T J, J^T r and the cost sum(r^2) of the points' rows, each entry summed
// over the points in index order by one thread
__device__ void normal_equations(const float* rj, int n, Sys* out) {
  const int t = threadIdx.x;
  if (t > 42) return;
  // the entry's two factors' columns: J^T J (a, c), J^T r (a, r), r^T r
  const int ca = t < 36 ? 1 + t / 6 : (t < 42 ? 1 + t - 36 : 0);
  const int cb = t < 36 ? 1 + t % 6 : 0;
  float s = 0.0f;
  int i = 0;
  for (; i + 8 <= n; i += 8) {  // eight rows' loads ahead of their additions, in order
    float pa[8], pb[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      pa[u] = rj[7 * (i + u) + ca];
      pb[u] = rj[7 * (i + u) + cb];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) s = s + pa[u] * pb[u];
  }
  for (; i < n; ++i) s = s + rj[7 * i + ca] * rj[7 * i + cb];
  if (t < 36)
    out->A[t] = s;
  else if (t < 42)
    out->g[t - 36] = s;
  else
    out->cost = s;
}

__global__ void __launch_bounds__(512) localize_kernel(
    const float* __restrict__ intr, const float* __restrict__ pix, const float* __restrict__ pts,
    const uint8_t* __restrict__ valid, const int64_t* __restrict__ samples,
    const float* __restrict__ grid_in, float threshold, int n, int h, float* __restrict__ fout,
    int* __restrict__ iout, uint8_t* __restrict__ inliers, long long* __restrict__ clocks) {
  // shared: bearings [n][3], points [n][3], the weights [n], rows [n][7],
  // the grid
  extern __shared__ __align__(16) float smem[];
  float* b = smem;
  float* X = b + 3 * n;
  float* w = X + 3 * n;
  float* rj = w + n;
  float* grid = rj + 7 * n;
  __shared__ Sys sys[2];  // the current normal equations and the candidate's, by turns
  __shared__ int cur_s;
  __shared__ float x[7], x_new[7], lam_s;
  __shared__ int done_s, bad_s, n_valid_s;
  __shared__ int warp_best[16], warp_top[16];
  CLOCK_DECL();
  CLOCK_START();

  // outputs and scratch: fout = pose [7], ransac pose [7], candidates [4h][7];
  // iout = best, count of the best, counts [4h], candidate validity [4h],
  // the LM's trips
  float* pose_out = fout;
  float* ransac_pose = fout + 7;
  float* cand = fout + 14;
  int* counts = iout + 2;
  int* cand_valid = counts + 4 * h;
  const int n_cand = 4 * h;

  // (a) unproject, the points and the grid into shared memory
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    vo::unproject(intr, pix + 2 * i, b + 3 * i);
    for (int k = 0; k < 3; ++k) X[3 * i + k] = pts[3 * i + k];
  }
  for (int i = threadIdx.x; i < kGrid; i += blockDim.x) grid[i] = grid_in[i];
  __syncthreads();
  MARK(kUnproject);

  // (b) P3P: a warp eight hypotheses at a time, lane 4 h + k hypothesis
  // h's root k; warp 0 first lists the valid points (in the weights' place,
  // which (d) fills), for (c)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  int* vidx = reinterpret_cast<int*>(w);
  if (warp == 0) {
    int cnt = 0;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const bool v = i0 + lane < n && valid[i0 + lane];
      const unsigned m = __ballot_sync(kFull, v);
      if (v) vidx[cnt + __popc(m & ((1u << lane) - 1u))] = i0 + lane;
      cnt += __popc(m);
    }
    if (lane == 0) n_valid_s = cnt;
  }
  for (int base = 8 * warp; base < h; base += 8 * nw) {
    const int hl = lane >> 2, k = lane & 3;
    const int hy = base + hl < h ? base + hl : h - 1;  // a warp's tail repeats the last
    float j[3][3], P[3][3];
    for (int p = 0; p < 3; ++p) {
      const int64_t s = samples[3 * hy + p];
      for (int c = 0; c < 3; ++c) {
        j[p][c] = b[3 * s + c];
        P[p][c] = X[3 * s + c];
      }
    }
    P3p st;
    p3p_setup(j, P, st);
    // the signs of the eight quartics on the grid, 32 points a ballot; a
    // lane keeps its hypothesis' 256 bits
    unsigned sgn[kGrid / 32];
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      float A[5];
#pragma unroll
      for (int e = 0; e < 5; ++e) A[e] = __shfl_sync(kFull, st.A[e], 4 * g);
#pragma unroll
      for (int c = 0; c < kGrid / 32; ++c) {
        const unsigned m = __ballot_sync(kFull, signbit(quartic(A, grid[32 * c + lane])));
        if (g == hl) sgn[c] = m;
      }
    }
    // the first four sign changes (i: the signs at i and i + 1 differ), in
    // index order; this lane's root takes the k-th
    int found = 0, mine = 0;
    bool change0 = false;
#pragma unroll
    for (int c = 0; c < kGrid / 32; ++c) {
      const unsigned next = (sgn[c] >> 1) | (c + 1 < kGrid / 32 ? sgn[c + 1] << 31 : 0u);
      unsigned chg = sgn[c] ^ next;
      if (c + 1 == kGrid / 32) chg &= 0x7fffffffu;  // the last point has no successor
      if (c == 0) change0 = (chg & 1u) != 0u;
      while (chg != 0u && found < 4) {
        if (found == k) mine = 32 * c + __ffs(chg) - 1;
        ++found;
        chg &= chg - 1u;
      }
    }
    float root, pose[7];
    bool root_ok, ok;
    quartic_root(st.A, grid, mine, k < found ? true : change0, &root, &root_ok);
    p3p_pose(j, P, st, root, root_ok, pose, &ok);
    if (base + hl < h) {
      for (int i = 0; i < 7; ++i) cand[7 * (4 * hy + k) + i] = pose[i];
      cand_valid[4 * hy + k] = ok ? 1 : 0;
    }
  }
  __syncthreads();
  MARK(kP3p);

  // (c) each valid candidate's inliers: a warp a candidate, its lanes over
  // the valid points
  const int nv = n_valid_s;
  for (int c = warp; c < n_cand; c += nw) {
    int count = 0;
    if (cand_valid[c]) {
      float inv[7];
      vo::se3_inverse(cand + 7 * c, inv);
      for (int k0 = 0; k0 < nv; k0 += 32) {
        bool in = false;
        if (k0 + lane < nv) {
          const int i = vidx[k0 + lane];
          in = angle_residual(inv, b + 3 * i, X + 3 * i) < threshold;
        }
        count += __popc(__ballot_sync(kFull, in));
      }
    }
    if (lane == 0) counts[c] = count;
  }
  __syncthreads();
  MARK(kScore);
  // (d) the first candidate with the most inliers: each warp's first best
  // (the larger count, then the smaller index) into shared memory
  {
    int best = -1, top = -1;
    for (int c = tid; c < n_cand; c += blockDim.x) {
      const int v = counts[c];
      if (v > top) {
        top = v;
        best = c;
      }
    }
    for (int d = 16; d > 0; d >>= 1) {
      const int ob = __shfl_xor_sync(kFull, best, d), ot = __shfl_xor_sync(kFull, top, d);
      if (ot > top || (ot == top && ob >= 0 && (best < 0 || ob < best))) {
        top = ot;
        best = ob;
      }
    }
    if (lane == 0) {
      warp_best[warp] = best;
      warp_top[warp] = top;
    }
  }
  __syncthreads();
  // every thread combines the warps' (in index order: the first of the
  // best), takes the best candidate and weighs the refinement with its
  // inliers
  int best = warp_best[0], top = warp_top[0];
  for (int k = 1; k < nw; ++k)
    if (warp_top[k] > top || (warp_top[k] == top && warp_best[k] < best)) {
      top = warp_top[k];
      best = warp_best[k];
    }
  if (tid == 0) {
    iout[0] = best;
    iout[1] = top;
    for (int i = 0; i < 7; ++i) {
      x[i] = cand[7 * best + i];
      ransac_pose[i] = x[i];
    }
    lam_s = 1e-4f;
    done_s = 0;
  }
  {
    float inv[7];
    vo::se3_inverse(cand + 7 * best, inv);
    const bool model_ok = cand_valid[best] != 0;
    for (int i = tid; i < n; i += blockDim.x)
      w[i] = (model_ok && angle_residual(inv, b + 3 * i, X + 3 * i) < threshold && valid[i])
                 ? 1.0f : 0.0f;
  }
  __syncthreads();
  MARK(kSelect);

  // (e) the LM of `lm_solve`: linearize at the start and solve the first
  // trip's step; then each trip linearizes at the candidate, and one thread
  // accepts or not and solves the next trip's step
  linearize_points(x, b, X, w, n, rj);
  __syncthreads();
  MARK(kLmLinearize);
  normal_equations(rj, n, &sys[0]);
  __syncthreads();
  MARK(kLmNormal);
  if (tid == 0) {
    cur_s = 0;
    lm_step(sys[0], lam_s, x, x_new, &bad_s);
  }
  __syncthreads();
  MARK(kLmSolve);
  int trips = 0;
  for (int it = 0; it < kLmIters; ++it) {
    ++trips;
    linearize_points(x_new, b, X, w, n, rj);
    __syncthreads();
    MARK(kLmLinearize);
    const int cur = cur_s;
    normal_equations(rj, n, &sys[1 - cur]);
    __syncthreads();
    MARK(kLmNormal);
    if (tid == 0) {
      const Sys &now = sys[cur], &nxt = sys[1 - cur];
      const bool accept = vo::finite(nxt.cost) && nxt.cost < now.cost && !bad_s;
      const bool converged = accept && (now.cost - nxt.cost <= 1e-6f * now.cost);
      if (accept) {
        for (int i = 0; i < 7; ++i) x[i] = x_new[i];
        cur_s = 1 - cur;
      }
      float lam = accept ? lam_s * 0.5f : lam_s * 4.0f;
      lam = lam < 1e-9f ? 1e-9f : (lam > 1e6f ? 1e6f : lam);
      lam_s = lam;
      done_s = converged ? 1 : 0;
      if (!converged && it + 1 < kLmIters) lm_step(sys[cur_s], lam_s, x, x_new, &bad_s);
    }
    __syncthreads();
    MARK(kLmSolve);
    if (done_s) break;
  }

  // (f) the refined pose's inliers
  if (threadIdx.x == 0) {
    for (int i = 0; i < 7; ++i) pose_out[i] = x[i];
    iout[2 + 8 * h] = trips;
  }
  float inv[7];
  vo::se3_inverse(x, inv);
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    inliers[i] = (angle_residual(inv, b + 3 * i, X + 3 * i) < threshold && valid[i]) ? 1 : 0;
  MARK(kReselect);
  CLOCK_OUT(clocks);
}

}  // namespace

// The launch: one block of `threads` threads on `stream`. fout: float32
// [14 + 28 h]; iout: int32 [3 + 8 h]; inliers: uint8 [n]; clocks
// [kStages], the clock build's cycles by stage (ignored by the plain
// build). Returns the CUDA error of the launch (0: launched).
extern "C" int evo_localize(const float* intr, const float* pix, const float* pts,
                            const uint8_t* valid, const int64_t* samples, const float* grid,
                            float threshold, int n, int h, int threads, float* fout, int* iout,
                            uint8_t* inliers, long long* clocks, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (14 * (size_t)n + kGrid);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        localize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  localize_kernel<<<1, threads, smem, stream>>>(intr, pix, pts, valid, samples, grid, threshold,
                                                n, h, fout, iout, inliers, clocks);
  return (int)cudaGetLastError();
}
