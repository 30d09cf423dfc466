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
// on one SM, in shared memory: the three planes and their private copies
// while it splats, then the image and its tangents beside the loss's strips
// (nine blurred products and lambda_1 with its tangents, for the rows one
// strip of pool outputs reads: the whole 60x60 tile in one strip, or 3 pool
// rows a strip of a 40 px tile's 120x120 image, whose three planes alone
// take 169 KB); nothing but r, J and `escaped` is written out. The splat
// follows `csrc/splat.cu`'s one-block-per-tile forward: events staged in
// chunks, one thread an event for its taps, then each depositing warp takes
// one event at a time, its 64 candidate taps spread over the lanes (no two
// lanes meet on an address), into its own plane of one private copy of the
// three (no atomics: a copy's three planes are three warps, each copy a
// share of the events); the copies are summed in order at the end. Every
// sum runs in one fixed order (a thread's pixels by index, then a fixed
// tree over the block), so a row's bits depend on that row alone, never on
// the rows launched beside it or on the strips, and padding events (valid
// false) change nothing.
//
// Built with -fmad=false, as the alignment kernel is: each product and sum
// rounds on its own. Rows whose window is not `live` are left unwritten.
// Nothing here allocates or synchronises with the host.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;         // a block: 16 warps
constexpr int kChunk = 128;           // events staged at a time
constexpr int K = 8;                  // candidate taps an axis (radius <= 3)
constexpr int kStride = kChunk + 1;   // odd: one tap of 32 events spreads over the banks
constexpr int kTapRows = 5 * K;       // kx, dkx, w ky, w s ky, w s dky
constexpr int kStageFloats = kTapRows * kStride + 3 * kChunk;
constexpr int kMaxSide = 120;         // the largest padded tile side taken (40 px tiles)
constexpr int kPool = 5, kPoolStep = 2;
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxSmem = 232448;      // 227 KB a block
constexpr int kDead = -1;
constexpr int kOutside = -2;
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
};

struct Shape {
  int E, side, rows_per_window, copies, plane_floats, loss, strip;
  float scale, tile, weight, inv_sigma, radius;
  float blur[4];  // the blur's taps at distance 0..3
};

// The Gaussian tap at d = grid - coordinate and its derivative with respect
// to the coordinate, zero beyond the radius (`kernels.splat._taps`).
__device__ __forceinline__ void gauss_tap(float d, float inv_sigma, float radius,
                                          float* k, float* dk) {
  if (fabsf(d) > radius) {
    *k = 0.0f;
    *dk = 0.0f;
    return;
  }
  const float q = d * inv_sigma;
  const float g = expf(-0.5f * q * q);
  *k = g;
  *dk = (g * q) * inv_sigma;
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

__global__ void __launch_bounds__(kThreads) comp_tile_kernel(Args a, Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int row = blockIdx.x;
  if (a.live != nullptr && a.live[row / s.rows_per_window] == 0) return;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int side = s.side, HW = side * side;
  float* planes = smem;
  float* tk = smem + s.plane_floats;  // [kTapRows][kStride]
  int* to = reinterpret_cast<int*>(tk + kTapRows * kStride);
  int* ty = to + kChunk;
  int* tx = ty + kChunk;
  // the reductions' scratch, past the image and its tangents once the
  // copies are summed
  float* red = smem + 3 * side * side;

  // ---- splat: three planes, one private copy of them per depositing warp
  for (int i = tid; i < s.copies * 3 * HW; i += kThreads) planes[i] = 0.0f;
  const float vx = a.vel[2 * row], vy = a.vel[2 * row + 1];
  const float ox = a.tlx[row], oy = a.tly[row];
  const size_t base = (size_t)row * s.E;
  const int i0 = lane / K, j0 = lane % K;  // a lane's taps: (i0, j0), (i0 + 4, j0)
  // depositing warp w: plane w % 3 of copy w / 3, which takes the chunk's
  // events c, c + copies, ...; its column taps, and its first row tap's row
  const int copy = warp / 3, plane = warp % 3;
  float* mine = planes + copy * 3 * HW + plane * HW;
  const int col = (plane == 1 ? K : 0) + j0, rows = (2 + plane) * K;
  for (int start = 0; start < s.E; start += kChunk) {
    const int cnt = min(kChunk, s.E - start);
    __syncthreads();  // the copies are zeroed; the last chunk is consumed
    for (int e = tid; e < cnt; e += kThreads) {
      const size_t g = base + start + e;
      to[e] = kDead;
      if (!a.valid[g]) continue;  // padding: weight 0 adds nothing
      const float sh = a.dt[g] * s.scale;
      const float px = ((a.ex[g] + sh * vx) - ox) + s.tile;
      const float py = ((a.ey[g] + sh * vy) - oy) + s.tile;
      if (!isfinite(px) || !isfinite(py)) continue;
      const int x0 = tap_base(px), y0 = tap_base(py);
      if (y0 + K <= 0 || y0 >= side || x0 + K <= 0 || x0 >= side) continue;
      const bool inside = y0 >= 0 && y0 + K <= side && x0 >= 0 && x0 + K <= side;
      to[e] = inside ? y0 * side + x0 : kOutside;
      ty[e] = y0;
      tx[e] = x0;
      const float w = s.weight, ws = w * sh;
      for (int i = 0; i < K; ++i) {
        float kx, dkx, ky, dky;
        gauss_tap((float)(x0 + i) - px, s.inv_sigma, s.radius, &kx, &dkx);
        gauss_tap((float)(y0 + i) - py, s.inv_sigma, s.radius, &ky, &dky);
        tk[(0 * K + i) * kStride + e] = kx;
        tk[(1 * K + i) * kStride + e] = dkx;
        tk[(2 * K + i) * kStride + e] = w * ky;
        tk[(3 * K + i) * kStride + e] = ws * ky;
        tk[(4 * K + i) * kStride + e] = ws * dky;
      }
    }
    __syncthreads();
    if (warp < 3 * s.copies) {
      for (int e = copy; e < cnt; e += s.copies) {
        const int off = to[e];
        if (off == kDead) continue;  // the same for the whole warp
        const float kc = tk[col * kStride + e];
        // the lane's two pixels of the stamp (-1: outside the image); both
        // values are loaded before either is stored, since the compiler
        // cannot tell the addresses apart and would wait on the store
        int at[2];
        float add[2], cur[2];
        for (int rr = 0; rr < 2; ++rr) {
          const int i = i0 + 4 * rr;
          if (off >= 0) {
            at[rr] = off + i * side + j0;
          } else {
            const int h = ty[e] + i, c = tx[e] + j0;
            at[rr] = (h < 0 || h >= side || c < 0 || c >= side) ? -1 : h * side + c;
          }
          add[rr] = tk[(rows + i) * kStride + e] * kc;
        }
        for (int rr = 0; rr < 2; ++rr) cur[rr] = at[rr] >= 0 ? mine[at[rr]] : 0.0f;
        for (int rr = 0; rr < 2; ++rr)
          if (at[rr] >= 0) mine[at[rr]] = cur[rr] + add[rr];
        __syncwarp();  // the next event may touch these pixels from other lanes
      }
    }
  }
  __syncthreads();
  // the copies summed in order, into copy 0: the image I and its tangents
  for (int i = tid; i < 3 * HW; i += kThreads) {
    float acc = planes[i];
    for (int c = 1; c < s.copies; ++c) acc += planes[c * 3 * HW + i];
    planes[i] = acc;
  }
  __syncthreads();
  const float* I = planes;
  const float* Ia = planes + HW;
  const float* Ib = planes + 2 * HW;

  // ---- escaped: the image's mean at or below 1e-4
  {
    float m[1] = {0.0f};
    for (int i = tid; i < HW; i += kThreads) m[0] += I[i];
    block_sum<1>(m, red);
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
    for (int o0 = 0; o0 < np; o0 += s.strip) {
      const int o1 = min(o0 + s.strip, np);
      const int h0 = kPoolStep * o0, n = (kPoolStep * (o1 - 1) + kPool - h0) * side;
      // vertical pass: the nine products (gx gx, gx gy, gy gy and their
      // tangents along vx, then vy) blurred along the columns
      for (int i = tid; i < n; i += kThreads) {
        const int h = h0 + i / side, w = i % side;
        float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (w < side - 1) {
          for (int k = -3; k <= 3; ++k) {
            const int hh = h + k;
            if (hh < 0 || hh >= side - 1) continue;  // outside, or the zero last row
            const int q = hh * side + w;
            const float gx = I[q + 1] - I[q], gy = I[q + side] - I[q];
            const float gxa = Ia[q + 1] - Ia[q], gya = Ia[q + side] - Ia[q];
            const float gxb = Ib[q + 1] - Ib[q], gyb = Ib[q + side] - Ib[q];
            const float g = s.blur[k < 0 ? -k : k];
            acc[0] += g * (gx * gx);
            acc[1] += g * (gx * gy);
            acc[2] += g * (gy * gy);
            acc[3] += g * (gxa * gx + gx * gxa);
            acc[4] += g * (gxa * gy + gx * gya);
            acc[5] += g * (gya * gy + gy * gya);
            acc[6] += g * (gxb * gx + gx * gxb);
            acc[7] += g * (gxb * gy + gx * gyb);
            acc[8] += g * (gyb * gy + gy * gyb);
          }
        }
        for (int c = 0; c < 9; ++c) V[c * SP + i] = acc[c];
      }
      __syncthreads();
      // horizontal pass, then lambda_1 and its tangents
      for (int i = tid; i < n; i += kThreads) {
        const int w = i % side, row = i - w;
        float S[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        for (int k = -3; k <= 3; ++k) {
          const int ww = w + k;
          if (ww < 0 || ww >= side) continue;
          const float g = s.blur[k < 0 ? -k : k];
          for (int c = 0; c < 9; ++c) S[c] += g * V[c * SP + row + ww];
        }
        // lam[0] the value, lam[1], lam[2] its tangents along vx, vy
        float lam[3];
        const float sxx = S[0], sxy = S[1], syy = S[2];
        const float tr = sxx + syy, dd = sxx - syy;
        const float disc2 = dd * dd + 4.0f * sxy * sxy;
        const bool dpass = disc2 >= 1e-12f;
        const float disc = sqrtf(disc2 < 1e-12f ? 1e-12f : disc2);
        // one quotient by a normal number (a zero numerator would take the
        // quotient's slow path on the card, in every empty pixel)
        const float half_inv = 0.5f / disc;
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
        L[i] = lam[0];
        L[SP + i] = lam[1];
        L[2 * SP + i] = lam[2];
      }
      __syncthreads();
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
    }
    // `red` lies on V, last read before the pool's barrier
    block_sum<3>(m, red);
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
                             kMaxSmem);
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
  const int HW = side * side;
  // as many private copies of the three planes as fit beside the staging
  // arrays, at most one plane per warp; then the loss keeps copy 0 (the
  // image and its tangents) and takes the memory past it for its strips
  // (twelve planes of a strip's rows: as many pool rows as fit) and the
  // reductions' scratch
  const int total = kMaxSmem / (int)sizeof(float);
  int copies = (total - kStageFloats) / (3 * HW);
  if (copies > kThreads / 32 / 3) copies = kThreads / 32 / 3;
  if (copies < 1) return (int)cudaErrorInvalidValue;
  const int plane_floats = (copies * 3 * HW + 3) / 4 * 4;
  const int np = (side - kPool) / kPoolStep + 1;
  int strip = ((total - 3 * HW) / (12 * side) - kPool + kPoolStep) / kPoolStep;
  if (strip > np) strip = np;
  if (strip < 1) return (int)cudaErrorInvalidValue;
  int work = 12 * (kPoolStep * (strip - 1) + kPool) * side;
  if (work < 4 * kThreads) work = 4 * kThreads;
  int floats = plane_floats + kStageFloats;
  if (floats < 3 * HW + work) floats = 3 * HW + work;
  const size_t smem = sizeof(float) * (size_t)floats;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  Shape s;
  s.E = E;
  s.side = side;
  s.rows_per_window = rows_per_window;
  s.copies = copies;
  s.plane_floats = plane_floats;
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
