// The frame's corner selection in one thread-block cluster: from the Harris
// response to the corners, strongest first, on the card.
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
// cluster of kCluster blocks does it all, without a host read; block r of
// the cluster owns the r-th slice of the candidate bitmask's words:
// 1. the largest response inside the border (NaN-propagating, as `max`):
//    each block over its slice, then every block reads the cluster's
//    through distributed shared memory (DSMEM);
// 2. the candidates (a peak of its 3x3 window, ties count, -inf padding;
//    inside the border; above quality x max and above 0) as a bitmask in the
//    block's shared memory, one bit a pixel (a warp's ballot a word), so any
//    number of them is held; in the same pass a histogram of their scores'
//    top 8 bits and their count;
// 3. where more than K = 4 max_corners, the K-th largest score by a radix
//    select over the float bits (the scores are positive, so their bits
//    order as they do), 8 bits a pass: the first digit from the cluster's
//    histograms of step 2, each later one from histograms of the candidates
//    that match the digits so far (the bitmask's set bits, not the image);
//    the candidates above it, and those equal to it in flat order up to K,
//    are gathered into rank 0's key list;
// 4. rank 0 sorts the keys (score bits, then the complement of the flat
//    index: score descending, ties to the lower index, the order of
//    `lax.top_k` and of the plain version's stable sort) bitonically, the
//    strides below 32 by warp shuffles between two barriers;
// 5. rank 0 runs the greedy pass 32 ranked candidates a step: first each
//    candidate's mask of the earlier candidates of its step that lie near
//    it, for all steps at once; then a step: lane l of every warp takes
//    candidate 32 s + l and tests it against the warp's share of the
//    accepted corners (a list in shared memory), and warp 0 resolves the
//    step in rank order by rounds of two ballots (a lane is accepted once
//    all its near earlier step-mates are refused, refused once one of them
//    is accepted), until max_corners are accepted.
//    Distances are d^2 < min_distance^2 on integer positions, which is
//    exact, so the set is the serial pass's.
// Nothing depends on the block's or the cluster's size but the time.
//
// The clock build (-DEVO_CS_CLOCKS, a library of its own) writes rank 0's
// cycles of each stage into `clocks` (`Stage`, `kernels.corner_select.
// STAGES`); the plain build ignores the pointer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
#ifndef EVO_CS_THREADS
#define EVO_CS_THREADS 1024
#endif
#ifndef EVO_CS_CLUSTER
#define EVO_CS_CLUSTER 8
#endif
constexpr int kThreads = EVO_CS_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = EVO_CS_CLUSTER;
static_assert(kThreads % 32 == 0 && kThreads >= 64, "whole warps, at least two");
static_assert(kCluster >= 1 && kCluster <= 8, "a portable cluster");
constexpr long long kSmemMax = 232448;

// Stage clock (-DEVO_CS_CLOCKS only): rank 0's thread 0 adds the clock64()
// cycles since the previous mark into a stage's bin; each MARK comes after a
// barrier, so a stage's time is its slowest thread's
enum Stage { kMax, kCandidates, kSelect, kSort, kGreedy, kWrite, kTotal, kStages };
#ifdef EVO_CS_CLOCKS
#define MARK(stage)                            \
  do {                                         \
    __syncthreads();                           \
    if (threadIdx.x == 0 && rank == 0) {       \
      const long long t_ = clock64();          \
      sh.bins[stage] += t_ - sh.last;          \
      sh.last = t_;                            \
    }                                          \
  } while (0)
#else
#define MARK(stage) ((void)0)
#endif

// A block's shared state, at the start of its dynamic shared memory (the
// fields marked "published" are read by the other blocks through DSMEM
// after a cluster barrier)
struct Shared {
  long long last, start, bins[kStages];  // the clock build's
  unsigned hist[2][256];  // published: the candidates' digits, by the radix pass's parity
  unsigned comb[256];     // the cluster's histogram
  int warp_int[kWarps];
  float warp_max[kWarps];
  float bmax;       // published: the largest response of the slice inside the border
  int bnan;         // published: a NaN there
  int count;        // published: candidates in the slice
  int eq, above;    // published: keys equal to the threshold, above it
  int total;        // a block scan's total
  int n_cand, base;
  float qmax;
  unsigned prefix, mask;  // the radix select's digits so far
  int remaining;          // how many of the keys that match `prefix` to take
  int eq_base, take_base, taken;
  int accepted;
  unsigned blocked[kWarps];  // the greedy step's candidates that each warp's accepted corners block
};
constexpr long long kSharedBytes = (sizeof(Shared) + 15) / 16 * 16;

struct Args {
  const float* resp;
  int H, W, border;
  float quality, min_d2;
  int max_corners, K, Kpad;
  float* xy;
  float* score;
  unsigned char* valid;
  long long* clocks;
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
  if (warp == 0) {  // the warps' totals, scanned by warp 0's lanes
    const int s = lane < kWarps ? sh.warp_int[lane] : 0;
    int x = s;
    for (int off = 1; off < 32; off <<= 1) {
      const int got = __shfl_sync(kFull, x, (lane - off) & 31);
      if (lane >= off) x += got;
    }
    if (lane < kWarps) sh.warp_int[lane] = x - s;
    if (lane == 31) sh.total = x;
  }
  __syncthreads();
  total = sh.total;
  const int out = sh.warp_int[warp] + inc - v;
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads) corner_select_kernel(Args a) {
  extern __shared__ __align__(16) float dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  // dynamic shared memory: the block's `Shared`, then (used by rank 0) the
  // Kpad keys, the accepted corners' positions and scores (max_corners
  // each), the candidates' masks of their near earlier step-mates (Kpad),
  // then the block's slice of the candidate bitmask
  Shared& sh = *reinterpret_cast<Shared*>(dyn);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(reinterpret_cast<char*>(dyn) + kSharedBytes);
  float2* accp = reinterpret_cast<float2*>(keys + a.Kpad);
  float* accs = reinterpret_cast<float*>(accp + a.max_corners);
  unsigned* before = reinterpret_cast<unsigned*>(accs + a.max_corners);
  unsigned* bits = before + a.Kpad;
  const float* resp = a.resp;
  const int H = a.H, W = a.W, border = a.border, K = a.K;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = H * W, words = (n + 31) / 32;
  const int per_block = (words + C - 1) / C;
  const int w0 = min(rank * per_block, words), w1 = min(w0 + per_block, words);
  const int nw = w1 - w0;
  if (tid == 0) sh.taken = 0;
  for (int d = tid; d < 512; d += kThreads) (&sh.hist[0][0])[d] = 0u;
#ifdef EVO_CS_CLOCKS
  if (tid == 0) {
    sh.start = sh.last = clock64();
    for (int k = 0; k < kStages; ++k) sh.bins[k] = 0;
  }
#endif

  // 1. the largest response inside the border: the slice's, then the
  // cluster's
  float m = -INFINITY;
  int nan_here = 0;
  for (int i = 32 * w0 + tid; i < min(32 * w1, n); i += kThreads) {
    const int y = i / W, x = i - y * W;
    if (!in_border(y, x, H, W, border)) continue;
    const float v = resp[i];
    if (v != v) nan_here = 1;
    else m = fmaxf(m, v);
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  if (lane == 0) sh.warp_max[warp] = m;
  const int any_nan = __syncthreads_or(nan_here);
  if (warp == 0) {  // the warps' maxima, then (after the barrier) the blocks', a lane each
    m = lane < kWarps ? sh.warp_max[lane] : -INFINITY;
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (lane == 0) {
      sh.bmax = m;
      sh.bnan = any_nan;
    }
  }
  cluster.sync();
  if (warp == 0) {
    float q = -INFINITY;
    int nan = 0;
    if (lane < C) {
      const Shared* o = cluster.map_shared_rank(&sh, lane);
      q = o->bmax;
      nan = o->bnan;
    }
    for (int off = 16; off > 0; off >>= 1) {
      q = fmaxf(q, __shfl_xor_sync(kFull, q, off));
      nan |= __shfl_xor_sync(kFull, nan, off);
    }
    if (lane == 0) sh.qmax = nan ? NAN : q;
  }
  __syncthreads();
  const float thr = a.quality * sh.qmax;
  MARK(kMax);

  // 2. the slice's candidate bitmask, a word a warp at a time (lane l tests
  // pixel 32 w + l, so the warp's loads are coalesced; a ballot makes the
  // word), its count and the histogram of the candidates' top digit
  int mine = 0;
  for (int w = w0 + warp; w < w1; w += kWarps) {
    const int i = 32 * w + lane;
    const bool c = i < n && candidate(resp, i, H, W, border, thr);
    const unsigned word = __ballot_sync(kFull, c);
    if (c) atomicAdd(&sh.hist[0][__float_as_uint(resp[i]) >> 24], 1u);
    if (lane == 0) {
      bits[w - w0] = word;
      mine += __popc(word);
    }
  }
  int count;
  block_scan(mine, sh, count);  // the total alone
  if (tid == 0) sh.count = count;
  cluster.sync();
  if (warp == 0) {  // the cluster's count and the blocks' before this one, a lane a block
    const int c = lane < C ? cluster.map_shared_rank(&sh, lane)->count : 0;
    int total = c, base = lane < rank ? c : 0;
    for (int off = 16; off > 0; off >>= 1) {
      total += __shfl_xor_sync(kFull, total, off);
      base += __shfl_xor_sync(kFull, base, off);
    }
    if (lane == 0) {
      sh.n_cand = total;
      sh.base = base;
      sh.prefix = 0;
      sh.mask = 0;
      sh.remaining = total < K ? total : K;
    }
  }
  __syncthreads();
  const int n_cand = sh.n_cand;
  const int n_sel = n_cand < K ? n_cand : K;
  MARK(kCandidates);

  // 3. the K-th largest score's bits (a radix select, most significant
  // digit first) where there are more than K candidates; every block finds
  // the same digits from the cluster's histograms
  const bool cut = n_cand > K;
  if (cut) {
    for (int pass = 0, shift = 24; shift >= 0; ++pass, shift -= 8) {
      const int cur = pass & 1;
      if (pass > 0) {  // the slice's candidates that match the digits so far
        const unsigned prefix = sh.prefix, mask = sh.mask;
        for (int d = tid; d < 256; d += kThreads) sh.hist[cur][d] = 0u;
        __syncthreads();
        for (int wl = tid; wl < nw; wl += kThreads) {
          unsigned word = bits[wl];
          while (word) {
            const int i = 32 * (w0 + wl) + __ffs(word) - 1;
            word &= word - 1u;
            const unsigned key = __float_as_uint(resp[i]);
            if ((key & mask) == prefix) atomicAdd(&sh.hist[cur][(key >> shift) & 255u], 1u);
          }
        }
        // a block reads another's hist[cur] only after this barrier, and
        // that block clears it again two passes on, after the next one
        cluster.sync();
      }
      for (int d = tid; d < 256; d += kThreads) {
        unsigned c = 0;
        for (int r = 0; r < C; ++r) c += cluster.map_shared_rank(&sh, r)->hist[cur][d];
        sh.comb[d] = c;
      }
      __syncthreads();
      if (tid == 0) {  // the digit where the count from the top reaches `remaining`
        int need = sh.remaining, d = 255;
        for (; d > 0; --d) {
          const int c = (int)sh.comb[d];
          if (c >= need) break;
          need -= c;
        }
        sh.remaining = need;
        sh.prefix |= (unsigned)d << shift;
        sh.mask |= 255u << shift;
      }
      __syncthreads();
    }
  }
  // gather into rank 0's list: every key above the threshold, and the first
  // `remaining` equal to it in flat order (all candidates where there are at
  // most K); thread t walks the t-th chunk of the slice's words, so thread
  // order is flat order within a block, and rank order across blocks
  const unsigned thr_key = cut ? sh.prefix : 0u;
  const int take_eq = cut ? sh.remaining : 0;
  const int chunk = (nw + kThreads - 1) / kThreads;
  const int lo = min(tid * chunk, nw), hi = min(lo + chunk, nw);
  int eq_rank = 0;
  if (cut) {
    int eq = 0, above = 0;
    for (int wl = lo; wl < hi; ++wl)
      for (unsigned word = bits[wl]; word; word &= word - 1u) {
        const unsigned key = __float_as_uint(resp[32 * (w0 + wl) + __ffs(word) - 1]);
        eq += key == thr_key;
        above += key > thr_key;
      }
    int eq_total, above_total;
    eq_rank = block_scan(eq, sh, eq_total);
    block_scan(above, sh, above_total);
    if (tid == 0) {
      sh.eq = eq_total;
      sh.above = above_total;
    }
    cluster.sync();
    if (tid == 0) {  // the equal keys and the takes of the blocks before this one
      int eb = 0, tb = 0;
      for (int r = 0; r < rank; ++r) {
        const Shared* o = cluster.map_shared_rank(&sh, r);
        tb += o->above + max(0, min(take_eq - eb, o->eq));
        eb += o->eq;
      }
      sh.eq_base = eb;
      sh.take_base = tb;
    }
    __syncthreads();
    eq_rank += sh.eq_base;
  } else if (tid == 0) {
    sh.take_base = sh.base;
  }
  __syncthreads();
  unsigned long long* keys0 = cluster.map_shared_rank(keys, 0);
  const int take_base = sh.take_base;
  for (int wl = lo; wl < hi; ++wl)
    for (unsigned word = bits[wl]; word; word &= word - 1u) {
      const int i = 32 * (w0 + wl) + __ffs(word) - 1;
      const unsigned key = __float_as_uint(resp[i]);
      bool take = !cut || key > thr_key;
      if (cut && key == thr_key) take = eq_rank++ < take_eq;
      if (take) {
        const int at = take_base + atomicAdd(&sh.taken, 1);
        keys0[at] = ((unsigned long long)key << 32) |
                    (unsigned long long)(0xffffffffu - (unsigned)i);
      }
    }
  if (rank == 0)
    for (int i = n_sel + tid; i < a.Kpad; i += kThreads) keys[i] = 0ull;  // below every key
  // rank 0's list is whole; no block reads another's memory after this
  cluster.sync();
  if (rank != 0) return;
  MARK(kSelect);

  // 4. bitonic sort, descending: a stride of 32 or more a pass over shared
  // memory, the strides below 32 of each run in registers by shuffles
  const int Kpad = a.Kpad;
  for (int size = 2; size <= Kpad; size <<= 1) {
    for (int stride = size >> 1; stride >= 32; stride >>= 1) {
      for (int i = tid; i < Kpad; i += kThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long x = keys[i], y = keys[j];
          const bool down = (i & size) == 0;  // this run descends
          if (down ? x < y : x > y) {
            keys[i] = y;
            keys[j] = x;
          }
        }
      }
      __syncthreads();
    }
    for (int i = tid; i < Kpad; i += kThreads) {  // whole warps: Kpad is a multiple of 32
      unsigned long long v = keys[i];
      const bool down = (i & size) == 0;
      for (int s = min(size >> 1, 16); s > 0; s >>= 1) {
        const unsigned long long o = __shfl_xor_sync(kFull, v, s);
        // the pair's lower index keeps the larger key where the run descends
        const bool keep_max = down == ((i & s) == 0);
        v = keep_max ? (v > o ? v : o) : (v < o ? v : o);
      }
      keys[i] = v;
    }
    __syncthreads();
  }
  MARK(kSort);

  // 5. the greedy pass in rank order, 32 candidates a step. First, every
  // key's flat index becomes its position (x, y) in 16 bits each, and each
  // candidate's mask of the earlier candidates of its step that lie near it
  const float min_d2 = a.min_d2;
  for (int r = tid; r < n_sel; r += kThreads) {
    const unsigned i = 0xffffffffu - (unsigned)(keys[r] & 0xffffffffull);
    const unsigned y = i / (unsigned)W, x = i - y * (unsigned)W;
    keys[r] = (keys[r] & 0xffffffff00000000ull) | (y << 16) | x;
  }
  __syncthreads();
  for (int r = tid; r < n_sel; r += kThreads) {
    const unsigned long long kr = keys[r];
    const float px = (float)(kr & 0xffffu), py = (float)((kr >> 16) & 0xffffu);
    unsigned m = 0u;
    for (int j = r & ~31; j < r; ++j) {
      const unsigned long long kj = keys[j];
      const float dx = (float)(kj & 0xffffu) - px, dy = (float)((kj >> 16) & 0xffffu) - py;
      if (dx * dx + dy * dy < min_d2) m |= 1u << (j & 31);
    }
    before[r] = m;
  }
  if (tid == 0) sh.accepted = 0;
  __syncthreads();
  // then a step: every warp tests the step's candidates (lane l: rank 32 s
  // + l) against its share of the accepted corners; warp 0 joins the tests
  // and, in rank order, accepts each candidate whose earlier neighbours in
  // the step are all refused and refuses each that an accepted one blocks
  // (rounds of two ballots, each deciding at least the first open lane)
  for (int base = 0; base < n_sel && sh.accepted < a.max_corners; base += 32) {
    const int acc = sh.accepted, r = base + lane;
    const bool have = r < n_sel;
    const unsigned long long kr = have ? keys[r] : 0ull;
    const float px = (float)(kr & 0xffffu), py = (float)((kr >> 16) & 0xffffu);
    bool near = false;
    for (int k = warp; k < acc; k += kWarps) {
      const float2 q = accp[k];
      const float dx = q.x - px, dy = q.y - py;
      near |= dx * dx + dy * dy < min_d2;
    }
    const unsigned blocked = __ballot_sync(kFull, near || !have);
    if (lane == 0) sh.blocked[warp] = blocked;
    __syncthreads();
    if (warp == 0) {
      unsigned refused = lane < kWarps ? sh.blocked[lane] : 0u, taken = 0u;
      for (int off = 16; off > 0; off >>= 1) refused |= __shfl_xor_sync(kFull, refused, off);
      const unsigned mine = have ? before[r] : 0u;
      while ((taken | refused) != kFull) {
        const bool open = !(((taken | refused) >> lane) & 1u);
        const unsigned take = __ballot_sync(kFull, open && (mine & ~refused) == 0u);
        refused |= __ballot_sync(kFull, open && (mine & taken) != 0u);
        taken |= take;
      }
      const int room = a.max_corners - acc;
      if (__popc(taken) > room) {  // the first `room` of them
        unsigned keep = 0u;
        for (int k = 0; k < room; ++k) {
          const unsigned rest = taken & ~keep;
          keep |= rest & (0u - rest);
        }
        taken = keep;
      }
      if ((taken >> lane) & 1u) {
        const int slot = acc + __popc(taken & ((1u << lane) - 1u));
        accp[slot] = make_float2(px, py);
        accs[slot] = __uint_as_float((unsigned)(kr >> 32));
      }
      if (lane == 0) sh.accepted = acc + __popc(taken);
    }
    __syncthreads();
  }
  MARK(kGreedy);
  for (int k = tid; k < a.max_corners; k += kThreads) {
    const bool ok = k < sh.accepted;
    a.xy[2 * k] = ok ? accp[k].x : 0.0f;
    a.xy[2 * k + 1] = ok ? accp[k].y : 0.0f;
    a.score[k] = ok ? accs[k] : 0.0f;
    a.valid[k] = ok;
  }
#ifdef EVO_CS_CLOCKS
  MARK(kWrite);
  if (tid == 0 && a.clocks) {
    sh.bins[kTotal] = sh.last - sh.start;
    for (int k = 0; k < kStages; ++k) a.clocks[k] = sh.bins[k];
  }
#endif
}

// the largest dynamic shared memory set for the kernel so far, after a check
// that a cluster with it can be placed (raised only: a launch of another
// shape never lowers it under a launch that needs more)
std::mutex placed_lock;
long long placed_smem = 0;

}  // namespace

// The dynamic shared memory a launch takes: the block's state, Kpad keys
// and masks, max_corners accepted positions and scores, and a block's slice
// of the bitmask
extern "C" long long evo_corner_select_smem(int H, int W, int Kpad, int max_corners) {
  const long long words = ((long long)H * W + 31) / 32;
  return kSharedBytes + 12LL * Kpad + 12LL * max_corners +
         4LL * ((words + kCluster - 1) / kCluster);
}

// Corners of the response resp [H, W] float32 into xy [max_corners, 2],
// score [max_corners] float32 and valid [max_corners] bytes; K = min(4
// max_corners, H W) candidates, Kpad the power of two at or above K and 32;
// clocks [kStages] int64 or null (written by the clock build only).
extern "C" int evo_corner_select(const void* resp, int H, int W, int border, float quality,
                                 float min_d2, int max_corners, int K, int Kpad, void* xy,
                                 void* score, void* valid, void* clocks, void* stream) {
  const long long smem = evo_corner_select_smem(H, W, Kpad, max_corners);
  if (smem > kSmemMax || max_corners < 1 || Kpad < 32 || Kpad % 32 != 0 || Kpad < K)
    return (int)cudaErrorInvalidValue;
  const Args args{(const float*)resp, H, W, border, quality, min_d2, max_corners, K, Kpad,
                  (float*)xy, (float*)score, (unsigned char*)valid, (long long*)clocks};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  std::lock_guard<std::mutex> hold(placed_lock);
  if (smem > placed_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        corner_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int placeable = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&placeable, corner_select_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (placeable < 1) return (int)cudaErrorInvalidConfiguration;
    placed_smem = smem;
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, corner_select_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
