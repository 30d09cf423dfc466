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
// (216 x 25 floats for 108 tiles, against 216^2), is factored by a banded
// Cholesky without pivoting and solved by forward and back substitution.
// `ok` is what `torch.linalg.cholesky_ex`'s `info == 0` says (LAPACK's
// test): every pivot positive and not NaN.
//
// What bounds it: latency. The factorisation is 2T pivots in series, each a
// square root, a reciprocal, a column scaled and a band-sized rank-1 update;
// the operations (~2T * band^2) are a fraction of a microsecond of the card.
// So a block of four warps runs a window (two barriers a pivot; warp 0 alone
// sums the costs and runs the back substitution) and the windows run side
// by side, one block each. Every sum runs in one fixed order (a lane's terms
// by index, then a fixed shuffle tree), so a window's bits depend on its own
// inputs alone.
//
// Built with -fmad=false, so that the costs, weights and assembly round as
// the plain version's elementwise operations do. Nothing here allocates or
// synchronises with the host.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kLanes = 32;
constexpr int kThreads = 128;  // a block: 4 warps a window
constexpr int kMaxBand = 64;
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kInit = 1, kTail = 2, kHead = 4;
constexpr int kBatch = 4;  // entries of the Cholesky's update a thread loads at once

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Where a window's band, right-hand side, edge weights and differences,
// the update's index pairs and the block's flags lie in shared memory.
struct Work {
  float* A;    // [n][band + 1]: A[i][k] = A(i, i - k)
  float* x;    // [n]: b, then the solution
  float* inv;  // [n]: 1 / L(i, i)
  float* w2;   // [E]
  float* d;    // [E][2]
  int* pairs;  // [band (band + 1) / 2]: (i' << 16) | k', 1 <= k' <= i' <= band
  int* flag;   // [4]: what one thread tells the block
};

__device__ __forceinline__ Work carve(float* smem, int n, int E, int band) {
  Work w;
  w.A = smem;
  w.x = w.A + n * (band + 1);
  w.inv = w.x + n;
  w.w2 = w.inv + n;
  w.d = w.w2 + E;
  w.pairs = reinterpret_cast<int*>(w.d + 2 * E);
  w.flag = w.pairs + band * (band + 1) / 2;
  return w;
}

__host__ __device__ inline size_t work_bytes(int n, int E, int band) {
  return sizeof(float) * ((size_t)n * (band + 3) + 3 * (size_t)E)
         + sizeof(int) * (size_t)(band * (band + 1) / 2 + 4);
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
    float* Ai = w.A + i * (band + 1);
    for (int k = 0; k <= band; ++k) Ai[k] = 0.0f;
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

// Banded Cholesky of the assembled band in place, the forward substitution
// L y = b folded into it, then the back substitution L^T x = y, into w.x.
// Returns whether every pivot was positive (not NaN); the same in every
// thread. The plain version's bits cannot be had here: LAPACK sums in its
// own blocked order. Against a float64 solve the two are equally close
// (fused multiply-adds in the updates were no closer, on the emulated
// tests' systems). Each pivot's reciprocal is taken once and multiplies (as
// LAPACK's unblocked factorisation scales its column): a quotient with a
// zero numerator takes the card's slow path. A pivot is two barriers: the
// 2T pivots run in series, so the block's four warps share each pivot's
// band-sized update (one warp alone issued it at a quarter of the rate).
__device__ bool factor_and_solve(const Work& w, int n, int band) {
  const int tid = threadIdx.x, ld = band + 1, np = band * (band + 1) / 2;
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
  return true;
}

__device__ void fill_pairs(const Work& w, int band) {
  for (int ip = 1 + threadIdx.x; ip <= band; ip += kThreads) {
    const int at = ip * (ip - 1) / 2;
    for (int kp = 1; kp <= ip; ++kp) w.pairs[at + kp - 1] = (ip << 16) | kp;
  }
  __syncthreads();
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
  fill_pairs(w, band);  // (its barrier also publishes w2 and d)
  GivenBlocks blk{jj + (size_t)win * 4 * T, jr + (size_t)win * n};
  assemble(w, blk, T, band, p, q, at, lam[win]);
  const bool good = factor_and_solve(w, n, band);
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
    if (done) return;
  }
  if (s.mode & kHead) {
    fill_pairs(w, s.band);
    edge_diffs(w, v, p, q, E);
    for (int e = tid; e < E; e += kThreads) {
      const float a = s.tv_weight * fabsf(w.d[2 * e]), b = s.tv_weight * fabsf(w.d[2 * e + 1]);
      const float nrm = sqrtf((a * a + b * b) + 1e-12f);
      // PyTorch takes `huber / n` of a Python number as (1 / n) * huber
      const float hw = nrm <= s.tv_huber ? 1.0f : (1.0f / nrm) * s.tv_huber;
      w.w2[e] = hw * s.tv_weight * s.tv_weight;
    }
    __syncthreads();
    ResidualBlocks blk{J, r};
    assemble(w, blk, T, s.band, p, q, at, lam);
    const bool good = factor_and_solve(w, n, s.band);
    const bool bad = !good || any_not_finite(w, n);
    for (int i = tid; i < n; i += kThreads) v_new[i] = v[i] + (bad ? 0.0f : -w.x[i]);
    if (tid == 0) st.bad[win] = bad ? 1 : 0;
  }
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
  LmShape s{T, E, band, mode, tv_weight, tv_huber};
  static bool allowed[64];
  const size_t smem = work_bytes(2 * T, E, band);
  cudaError_t err = allow_smem((const void*)comp_lm_step_kernel, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  comp_lm_step_kernel<<<W, kThreads, smem, (cudaStream_t)stream>>>(st, s, p, q,
                                                                 Incidence{start, inc});
  return (int)cudaGetLastError();
}
