// The frame's corner selection in one block: from the Harris response to the
// corners, strongest first, on the card.
//
// Replaces the selection of `evo_tpu/kernels/harris.py::detect_corners`
// (:49): the border mask, the quality threshold against the largest response
// inside the border (:79), the 3x3 non-maximum suppression, `lax.top_k` of
// 4 x max_corners candidates and the greedy min-distance pass that JAX runs
// as a `while_loop` fixpoint (:119), then the compaction in rank order. XLA
// device code, no Pallas kernel. Its plain PyTorch version is
// `evo_tpu_torch/kernels/corner_select.py::corner_select_ref` (a stable
// sort, then OpenCV's greedy pass on the host), which gives the same set.
//
// What bounds it: latency. It reads the response (173 KB at 240x180) a few
// times from L2 and does a few operations a pixel; the greedy pass is serial
// by nature (each candidate depends on the ones accepted before it). So one
// block does it all, without a host read:
// 1. the largest response inside the border (NaN-propagating, as `max`);
// 2. the candidates (a peak of its 3x3 window, ties count, -inf padding;
//    inside the border; above quality x max and above 0) as a bitmask in
//    shared memory, one bit a pixel (a warp's ballot a word), so any number
//    of them is held;
// 3. where more than K = 4 max_corners, the K-th largest score by a radix
//    select over the float bits (the scores are positive, so their bits
//    order as they do), 8 bits a pass; the candidates above it, and those
//    equal to it in flat order up to K, are gathered;
// 4. a bitonic sort of the K keys (score bits, then the complement of the
//    flat index): score descending, ties to the lower index, the order of
//    `lax.top_k` and of the plain version's stable sort;
// 5. warp 0 runs the greedy pass in rank order, the accepted corners in its
//    lanes' registers (up to 256) and a ballot a candidate (d^2 <
//    min_distance^2, exact on integer positions), and stops at max_corners.
// Nothing depends on the block's size but the time.
//
// The clock build (-DEVO_CS_CLOCKS, a library of its own) writes the cycles
// of each stage into `clocks` (`Stage`, `kernels.corner_select.STAGES`);
// the plain build ignores the pointer.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
#ifndef EVO_CS_THREADS
#define EVO_CS_THREADS 1024
#endif
constexpr int kThreads = EVO_CS_THREADS;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0 && kThreads >= 64, "whole warps, at least two");
constexpr int kAccSlots = 8;  // accepted corners a lane of the greedy warp holds
constexpr int kMaxCorners = 32 * kAccSlots;

// Stage clock (-DEVO_CS_CLOCKS only): thread 0 adds the clock64() cycles
// since the previous mark into a stage's bin; each MARK comes after a
// barrier, so a stage's time is its slowest thread's
enum Stage { kMax, kCandidates, kSelect, kSort, kGreedy, kWrite, kTotal, kStages };
#ifdef EVO_CS_CLOCKS
#define MARK(stage)                            \
  do {                                         \
    __syncthreads();                           \
    if (threadIdx.x == 0) {                    \
      const long long t_ = clock64();          \
      sh.bins[stage] += t_ - sh.last;          \
      sh.last = t_;                            \
    }                                          \
  } while (0)
#else
#define MARK(stage) ((void)0)
#endif

struct Shared {
  long long last, start, bins[kStages];  // the clock build's
  unsigned hist[256];
  int warp_int[kWarps];
  float warp_max[kWarps];
  int count;     // candidates, then gathered keys
  float qmax;
  unsigned prefix, mask;  // the radix select's digits so far
  int remaining;          // how many of the keys that match `prefix` to take
  int accepted;
};

__device__ __forceinline__ bool in_border(int y, int x, int H, int W, int border) {
  return x >= border && x < W - border && y >= border && y < H - border;
}

// is pixel i a candidate: a peak of its 3x3 window (ties count; a NaN in
// the window wins, as in max_pool2d), inside the border, above thr and 0.
// With a border of 1 or more the window lies inside the image: its nine
// loads carry no test, so they issue together.
__device__ __forceinline__ bool candidate(const float* resp, int i, int H, int W, int border,
                                          float thr) {
  const int y = i / W, x = i - y * W;
  if (!in_border(y, x, H, W, border)) return false;
  const float v = resp[i];
  float m = v;
  if (border >= 1) {
    float u[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) u[k] = resp[(size_t)(y + k / 3 - 1) * W + x + k % 3 - 1];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      if (u[k] > m || u[k] != u[k]) m = u[k];
  } else {
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx) {
        const int yy = y + dy, xx = x + dx;
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;  // -inf padding
        const float u = resp[(size_t)yy * W + xx];
        if (u > m || u != u) m = u;
      }
  }
  return v >= m && v > thr && v > 0.0f;
}

__device__ __forceinline__ bool is_cand(const unsigned* bits, int i) {
  return (bits[i >> 5] >> (i & 31)) & 1u;
}

// exclusive prefix sum of v over the block, in thread order; `total` gets
// the sum. Every thread must call it.
__device__ int block_scan(int v, Shared& sh, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int got = __shfl_sync(kFull, inc, (lane - off) & 31);
    if (lane >= off) inc += got;
  }
  if (lane == 31) sh.warp_int[warp] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int s = sh.warp_int[w];
      sh.warp_int[w] = acc;
      acc += s;
    }
    sh.count = acc;
  }
  __syncthreads();
  total = sh.count;
  const int out = sh.warp_int[warp] + inc - v;
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
corner_select_kernel(const float* __restrict__ resp, int H, int W, int border, float quality,
                     float min_d2, int max_corners, int K, int Kpad, float* __restrict__ xy,
                     float* __restrict__ score, unsigned char* __restrict__ valid,
                     long long* __restrict__ clocks) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ Shared sh;
  // dynamic shared memory: the Kpad keys, the ranked candidates' positions
  // (Kpad float2), the accepted corners' ranks (max_corners), then the
  // candidate bitmask
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(dyn);
  float2* pos = reinterpret_cast<float2*>(keys + Kpad);
  int* acc_rank = reinterpret_cast<int*>(pos + Kpad);
  unsigned* bits = reinterpret_cast<unsigned*>(acc_rank + max_corners);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = H * W, words = (n + 31) / 32;
#ifdef EVO_CS_CLOCKS
  if (tid == 0) {
    sh.start = sh.last = clock64();
    for (int k = 0; k < kStages; ++k) sh.bins[k] = 0;
  }
#endif

  // 1. the largest response inside the border
  float m = -INFINITY;
  int nan_here = 0;
  for (int i = tid; i < n; i += kThreads) {
    const int y = i / W, x = i - y * W;
    if (!in_border(y, x, H, W, border)) continue;
    const float v = resp[i];
    if (v != v) nan_here = 1;
    else m = fmaxf(m, v);
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) sh.warp_max[warp] = m;
  const int any_nan = __syncthreads_or(nan_here);
  if (tid == 0) {
    float q = sh.warp_max[0];
    for (int w = 1; w < kWarps; ++w) q = fmaxf(q, sh.warp_max[w]);
    sh.qmax = any_nan ? NAN : q;
  }
  __syncthreads();
  const float thr = quality * sh.qmax;
  MARK(kMax);

  // 2. the candidate bitmask, a word a warp at a time (lane l tests pixel
  // 32 w + l, so the warp's loads are coalesced; a ballot makes the word),
  // and their count
  int mine = 0;
  for (int w = warp; w < words; w += kWarps) {
    const int i = 32 * w + lane;
    const unsigned word = __ballot_sync(kFull, i < n && candidate(resp, i, H, W, border, thr));
    if (lane == 0) {
      bits[w] = word;
      mine += __popc(word);
    }
  }
  int n_cand;
  block_scan(mine, sh, n_cand);  // the total alone
  const int n_sel = n_cand < K ? n_cand : K;
  MARK(kCandidates);

  // 3. the K-th largest score's bits (a radix select, most significant
  // digit first) where there are more than K candidates
  if (tid == 0) {
    sh.prefix = 0;
    sh.mask = 0;
    sh.remaining = n_sel;
  }
  __syncthreads();
  if (n_cand > K) {
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int d = tid; d < 256; d += kThreads) sh.hist[d] = 0;
      __syncthreads();
      const unsigned prefix = sh.prefix, mask = sh.mask;
      for (int i = tid; i < n; i += kThreads) {
        if (!is_cand(bits, i)) continue;
        const unsigned key = __float_as_uint(resp[i]);
        if ((key & mask) == prefix) atomicAdd(&sh.hist[(key >> shift) & 255u], 1u);
      }
      __syncthreads();
      if (tid == 0) {  // the digit where the count from the top reaches `remaining`
        int need = sh.remaining, d = 255;
        for (; d > 0; --d) {
          const int c = (int)sh.hist[d];
          if (c >= need) break;
          need -= c;
        }
        sh.remaining = need;
        sh.prefix = prefix | ((unsigned)d << shift);
        sh.mask = mask | (255u << shift);
      }
      __syncthreads();
    }
  }
  // gather: every key above the threshold, and the first `remaining` equal
  // to it in flat order (all candidates where there are at most K)
  const bool cut = n_cand > K;
  const unsigned thr_key = cut ? sh.prefix : 0u;
  const int take_eq = cut ? sh.remaining : 0;
  const int chunk = (n + kThreads - 1) / kThreads;
  const int lo = tid * chunk, hi = min(lo + chunk, n);
  int eq = 0;
  if (cut)
    for (int i = lo; i < hi; ++i)
      if (is_cand(bits, i) && __float_as_uint(resp[i]) == thr_key) ++eq;
  int eq_total;
  const int eq_before = block_scan(eq, sh, eq_total);
  if (tid == 0) sh.count = 0;
  __syncthreads();
  int eq_rank = eq_before;
  for (int i = lo; i < hi; ++i) {
    if (!is_cand(bits, i)) continue;
    const unsigned key = __float_as_uint(resp[i]);
    bool take = !cut || key > thr_key;
    if (cut && key == thr_key) take = eq_rank++ < take_eq;
    if (take) {
      const int at = atomicAdd(&sh.count, 1);
      keys[at] = ((unsigned long long)key << 32) | (unsigned long long)(0xffffffffu - (unsigned)i);
    }
  }
  __syncthreads();
  for (int i = n_sel + tid; i < Kpad; i += kThreads) keys[i] = 0ull;  // below every key
  __syncthreads();
  MARK(kSelect);

  // 4. bitonic sort, descending
  for (int size = 2; size <= Kpad; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < Kpad; i += kThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long a = keys[i], b = keys[j];
          const bool down = (i & size) == 0;  // this run descends
          if (down ? a < b : a > b) {
            keys[i] = b;
            keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // the ranked candidates' positions, side by side
  for (int r = tid; r < n_sel; r += kThreads) {
    const int i = (int)(0xffffffffu - (unsigned)(keys[r] & 0xffffffffull));
    pos[r] = make_float2((float)(i % W), (float)(i / W));
  }
  __syncthreads();
  MARK(kSort);

  // 5. the greedy pass in rank order, warp 0: lane l holds accepted corners
  // l, l + 32, ... in registers (kAccSlots of them), so a candidate costs a
  // broadcast load, a few compares and a ballot; then every thread writes
  // the outputs
  if (warp == 0) {
    float ax[kAccSlots], ay[kAccSlots];
#pragma unroll
    for (int k = 0; k < kAccSlots; ++k) ax[k] = ay[k] = 0.0f;
    int acc = 0;
    for (int r = 0; r < n_sel && acc < max_corners; ++r) {
      const float2 p = pos[r];
      bool near = false;
#pragma unroll
      for (int k = 0; k < kAccSlots; ++k) {
        const float dx = ax[k] - p.x, dy = ay[k] - p.y;
        near = near || (lane + 32 * k < acc && dx * dx + dy * dy < min_d2);
      }
      if (__ballot_sync(kFull, near) == 0u) {
#pragma unroll
        for (int k = 0; k < kAccSlots; ++k)
          if (acc == lane + 32 * k) {
            ax[k] = p.x;
            ay[k] = p.y;
          }
        if (lane == 0) acc_rank[acc] = r;
        ++acc;
      }
    }
    if (lane == 0) sh.accepted = acc;
  }
  __syncthreads();
  MARK(kGreedy);
  for (int a = tid; a < max_corners; a += kThreads) {
    const bool ok = a < sh.accepted;
    xy[2 * a] = ok ? pos[acc_rank[a]].x : 0.0f;
    xy[2 * a + 1] = ok ? pos[acc_rank[a]].y : 0.0f;
    score[a] = ok ? __uint_as_float((unsigned)(keys[acc_rank[a]] >> 32)) : 0.0f;
    valid[a] = ok;
  }
#ifdef EVO_CS_CLOCKS
  MARK(kWrite);
  if (tid == 0 && clocks) {
    sh.bins[kTotal] = sh.last - sh.start;
    for (int k = 0; k < kStages; ++k) clocks[k] = sh.bins[k];
  }
#endif
}

}  // namespace

// The dynamic shared memory a launch takes: Kpad keys and positions,
// max_corners ranks, and the bitmask
extern "C" long long evo_corner_select_smem(int H, int W, int Kpad, int max_corners) {
  return 16LL * Kpad + 4LL * max_corners + 4LL * (((long long)H * W + 31) / 32);
}

// Corners of the response resp [H, W] float32 into xy [max_corners, 2],
// score [max_corners] float32 and valid [max_corners] bytes; K = min(4
// max_corners, H W) candidates, Kpad the power of two at or above K; clocks
// [kStages] int64 or null (written by the clock build only).
extern "C" int evo_corner_select(const void* resp, int H, int W, int border, float quality,
                                 float min_d2, int max_corners, int K, int Kpad, void* xy,
                                 void* score, void* valid, void* clocks, void* stream) {
  const long long smem = evo_corner_select_smem(H, W, Kpad, max_corners);
  if (smem > 232448 || max_corners > kMaxCorners) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        corner_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  corner_select_kernel<<<1, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
      (const float*)resp, H, W, border, quality, min_d2, max_corners, K, Kpad, (float*)xy,
      (float*)score, (unsigned char*)valid, (long long*)clocks);
  return (int)cudaGetLastError();
}
