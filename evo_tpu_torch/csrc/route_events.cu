// Event routing in one launch: each event of a sub-batch is appended to the
// ring of every live patch whose 25 x 25 rect holds it, and each ring keeps
// its patch's newest E events.
//
// Replaces `evo_tpu/tracker/patch_state.py::route_events` (:102-187): XLA
// device code, no Pallas kernel, which on the TPU is a [P, N] hit mask, a
// cumsum rank and base-128 bf16 one-hot einsums that scatter the kept
// events' indices. Its plain PyTorch version is
// `evo_tpu_torch/tracker/patch_state.py::route_events_ref`, whose rules this
// file keeps to the bit: an event hits a patch when |ex - cx| <= 12 and
// |ey - cy| <= 12, the patch is alive and the event valid; the k-th hit
// (1-based, in event order) of a patch with `tot` hits is kept when
// k > tot - E and lands in slot (ev_count + k - 1) mod E; ev_count and
// counter grow by tot. Its only arithmetic is those subtractions and
// compares, so the rings carry the events' own bits.
//
// What bounds it: latency. A sub-batch is ~5,000 events (4,096-multiples in
// dense windows, 12,288 at most on the main path) against 128 patches. A
// block serves a patch, and the blocks of a thread-block cluster (kCluster
// patches) share the reading of the sub-batch:
//  - hit words. A warp loads 32 consecutive events (coalesced: one line a
//    field) and, for each of the cluster's patches, one ballot gives the
//    patch's 32-bit hit word; lane q stores patch q's word into block q's
//    shared memory through DSMEM. The cluster's warps take the sub-batch's
//    words in turn, so the cluster reads it once (the parent design read
//    it twice a patch, 64 B apart a lane);
//  - after one cluster barrier a block holds its patch's words in event
//    order. A thread takes a run of them; one block scan of the runs'
//    popcounts gives `tot` and each run's first rank; a thread walks its
//    run's set bits and puts each kept hit's event index at its slot in
//    shared memory; then the block writes its patch's whole new ring row in
//    slot order (coalesced), each slot once: the kept hit's event, gathered
//    by index, or the old entry. The input is never written, and nothing is
//    read back. (Scattered stores a hit, as the parent design wrote the kept
//    hits, measured slower than the whole row.)
// A sub-batch longer than kChunk events is taken kChunk at a time: a first
// pass counts each patch's hits (the threshold of the kept ranks needs the
// total), a second ranks and writes, with a cluster barrier after each
// chunk's words are read so the next may overwrite them. Nothing depends on
// the block's, the cluster's or the chunk's size but the time.
//
// The clock build (-DEVO_RE_CLOCKS, a library of its own) writes each
// patch's block's cycles of each stage into `clocks` [P, kStages] (`Stage`,
// `kernels.route_events.STAGES`); the plain build ignores the pointer.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

#include "block_scan.cuh"

namespace cg = cooperative_groups;

#ifndef EVO_RE_THREADS
#define EVO_RE_THREADS 512  // the emulated tests build it with fewer
#endif
#ifndef EVO_RE_CLUSTER
#define EVO_RE_CLUSTER 8  // and smaller clusters
#endif
#ifndef EVO_RE_CHUNK
#define EVO_RE_CHUNK 65536  // and shorter chunks
#endif

namespace {

constexpr int kThreads = EVO_RE_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = EVO_RE_CLUSTER;  // patches a cluster, a block each
constexpr int kChunk = EVO_RE_CHUNK;      // events a pass takes at a time
constexpr int kChunkWords = kChunk / 32;
constexpr int kBatch = 4;  // words a warp loads before it tests any
constexpr unsigned kFull = 0xffffffffu;
constexpr float kExtent = 12.0f;  // patch_state.PATCH_EXTENT
constexpr int kRing = 4;          // ev_t, ev_x, ev_y, ev_p
// the longest ring a launch takes (kernels/route_events.py::MAX_RING): a
// block holds a slot's event index for each slot of its patch's ring, and
// with a chunk's words stays under the 48 KB of shared memory a launch
// takes without an attribute
constexpr int kMaxRing = 8192;

static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps, one block");
static_assert(kCluster >= 1 && kCluster <= 8, "a portable cluster");
static_assert(kChunk >= 32 && kChunk % 32 == 0, "whole words");
static_assert(4 * (kWarps + 4 + kChunk / 32 + kMaxRing) <= 48 * 1024, "shared memory");

// Stage clock (-DEVO_RE_CLOCKS only): thread 0 adds the clock64() cycles
// since the previous mark into a stage's bin; each MARK comes after a
// barrier, so a stage's time is its slowest thread's
enum Stage { kLoad, kSync, kScan, kWrite, kCopy, kTotal, kStages };
#ifdef EVO_RE_CLOCKS
#define MARK(stage)                      \
  do {                                   \
    __syncthreads();                     \
    if (threadIdx.x == 0) {              \
      const long long t_ = clock64();    \
      bins[stage] += t_ - last;          \
      last = t_;                         \
    }                                    \
  } while (0)
#else
#define MARK(stage) ((void)0)
#endif

struct Args {
  const float* center;          // [P, 2]
  const unsigned char* alive;   // [P]
  const int* ev_count;          // [P]
  const int* counter;           // [P]
  const float* ring[kRing];     // [P, E] ev_t, ev_x, ev_y, ev_p
  const float* ev[kRing];       // [N] et, ex, ey, ep: each ring's events
  const unsigned char* mask;    // [N]
  float* ring_out[kRing];       // [P, E]
  int* ev_count_out;            // [P]
  int* counter_out;             // [P]
  long long* clocks;            // [P, kStages] the clock build's, or null
  int P, E, N;
};

// the block's dynamic shared memory: the block scan's warp totals, its
// patch's hit words of a chunk, then each ring slot's kept event
constexpr int kScanInts = (kWarps + 1 + 3) / 4 * 4;

__device__ int py_mod(long long v, int m) {
  const long long r = v % m;
  return (int)(r < 0 ? r + m : r);
}

// The cluster's patches' hit words of the chunk's events [lo, hi) into each
// patch's block (`words` of block q: patch q's word w for events lo + 32 w +
// [0, 32)). Every block of the cluster calls it; a cluster barrier must
// follow before the words are read.
__device__ void hit_words(const Args& a, unsigned* words, int lo, int hi, const float* pcx,
                          const float* pcy, const bool* palive) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  const int n_words = (hi - lo + 31) / 32;
  const int stride = kCluster * kWarps;
  unsigned* dst = cluster.map_shared_rank(words, (unsigned)(lane < kCluster ? lane : 0));
  for (int w0 = (int)cluster.block_rank() * kWarps + (threadIdx.x >> 5); w0 < n_words;
       w0 += stride * kBatch) {
    // every load of the batch issued before any test
    float ex[kBatch], ey[kBatch];
    bool valid[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int i = lo + 32 * (w0 + b * stride) + lane;
      const bool in = w0 + b * stride < n_words && i < hi;
      const int at = in ? i : lo;
      valid[b] = in && a.mask[at] != 0;
      ex[b] = a.ev[1][at];
      ey[b] = a.ev[2][at];
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int w = w0 + b * stride;
      if (w >= n_words) break;  // the same for the whole warp
      unsigned mine = 0;  // lane q: patch q's word
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        const bool hit = valid[b] && palive[q] && fabsf(ex[b] - pcx[q]) <= kExtent &&
                         fabsf(ey[b] - pcy[q]) <= kExtent;
        const unsigned m = __ballot_sync(kFull, hit);
        if (lane == q) mine = m;
      }
      if (lane < kCluster) dst[w] = mine;
    }
  }
}

// This thread's run [wlo, whi) of a chunk's n_words words (the runs in
// thread order) and its hits
__device__ int run_count(const unsigned* words, int n_words, int& wlo, int& whi) {
  const int run = (n_words + kThreads - 1) / kThreads;
  wlo = min(n_words, (int)threadIdx.x * run);
  whi = min(n_words, wlo + run);
  int n = 0;
  for (int w = wlo; w < whi; ++w) n += __popc(words[w]);
  return n;
}

__global__ void __launch_bounds__(kThreads) route_events_kernel(Args a) {
  extern __shared__ __align__(16) float dyn[];
  const int P = a.P, E = a.E, N = a.N;
  int* warp_int = reinterpret_cast<int*>(dyn);
  unsigned* words = reinterpret_cast<unsigned*>(dyn) + kScanInts;
  int* src = reinterpret_cast<int*>(words + min(kChunkWords, (N + 31) / 32));  // [E]
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int first_p = (int)(blockIdx.x - cluster.block_rank());  // the cluster's first patch
  const int p = (int)blockIdx.x;
  const bool mine = p < P;  // a block past the last patch only reads events
#ifdef EVO_RE_CLOCKS
  long long bins[kStages] = {}, last = clock64();
  const long long start = last;
#endif

  // the cluster's patches, and this block's counts (loaded with them, one
  // round of loads)
  float pcx[kCluster], pcy[kCluster];
  bool palive[kCluster];
#pragma unroll
  for (int q = 0; q < kCluster; ++q) {
    const int pq = min(first_p + q, P - 1);
    palive[q] = first_p + q < P && a.alive[pq] != 0;
    pcx[q] = a.center[2 * pq];
    pcy[q] = a.center[2 * pq + 1];
  }
  const int count = mine ? a.ev_count[p] : 0, counter = mine ? a.counter[p] : 0;

  const int chunks = (N + kChunk - 1) / kChunk;
  int tot = 0;
  if (chunks > 1) {  // the first pass: each patch's hits
    for (int c = 0; c < chunks; ++c) {
      const int lo = c * kChunk, hi = min(N, lo + kChunk);
      hit_words(a, words, lo, hi, pcx, pcy, palive);
      MARK(kLoad);
      cluster.sync();
      MARK(kSync);
      if (mine) {
        int wlo, whi, chunk;
        block_scan<kWarps>(run_count(words, (hi - lo + 31) / 32, wlo, whi), warp_int, chunk);
        tot += chunk;
      }
      MARK(kScan);
      cluster.sync();  // the words read before the next chunk's overwrite them
      MARK(kSync);
    }
  }

  // the kept hits, ranks base + 1 .. tot, fill `kept` consecutive slots
  // (mod E) from `first`; src[s] gets the event of slot s
  int kept = min(tot, E), base = tot - kept, first = py_mod((long long)count + base, E);
  int before = 0;  // the hits of the chunks before
  for (int c = 0; c < chunks; ++c) {
    const int lo = c * kChunk, hi = min(N, lo + kChunk);
    hit_words(a, words, lo, hi, pcx, pcy, palive);
    MARK(kLoad);
    cluster.sync();
    MARK(kSync);
    if (mine) {
      int wlo, whi, chunk;
      int rank = before + block_scan<kWarps>(run_count(words, (hi - lo + 31) / 32, wlo, whi),
                                             warp_int, chunk);
      if (chunks == 1) {
        tot = chunk;
        kept = min(tot, E);
        base = tot - kept;
        first = py_mod((long long)count + base, E);
      }
      MARK(kScan);
      // the run's kept hits: their events by slot
      for (int w = wlo; w < whi; ++w) {
        unsigned m = words[w];
        if (rank + __popc(m) <= base) {
          rank += __popc(m);
          continue;
        }
        for (; m; m &= m - 1)
          if (++rank > base) {
            const int s = first + rank - base - 1;
            src[s < E ? s : s - E] = lo + 32 * w + __ffs(m) - 1;
          }
      }
      before += chunk;
      MARK(kWrite);
    }
    if (c + 1 < chunks) {
      cluster.sync();  // the words read before the next chunk's overwrite them
      MARK(kSync);
    }
  }
  if (!mine) return;  // no block reads another's words any more
  __syncthreads();

  // the new ring row in order, each slot written once: a kept hit's event,
  // else the old entry
  const size_t at = (size_t)p * E;
  for (int j = t; j < E; j += kThreads) {
    const int o = j - first;
    if ((o < 0 ? o + E : o) < kept) {
      const int i = src[j];
      for (int k = 0; k < kRing; ++k) a.ring_out[k][at + j] = a.ev[k][i];
    } else {
      for (int k = 0; k < kRing; ++k) a.ring_out[k][at + j] = a.ring[k][at + j];
    }
  }
  if (t == 0) {
    a.ev_count_out[p] = (int)((unsigned)count + (unsigned)tot);
    a.counter_out[p] = (int)((unsigned)counter + (unsigned)tot);
  }
  MARK(kCopy);
#ifdef EVO_RE_CLOCKS
  if (t == 0 && a.clocks) {
    bins[kTotal] = last - start;
    for (int k = 0; k < kStages; ++k) a.clocks[(size_t)p * kStages + k] = bins[k];
  }
#endif
}

}  // namespace

// One launch over the P patches: ceil(P / kCluster) clusters of kCluster
// blocks. `ptrs` holds the Args pointers in their order
// (`kernels/route_events.py::POINTERS`). E from 1 to kMaxRing.
extern "C" int evo_route_events(const void* const* ptrs, int P, int E, int N, void* stream) {
  if (P < 0 || E < 1 || E > kMaxRing || N < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  Args a;
  memcpy(&a, ptrs, offsetof(Args, P));
  a.P = P;
  a.E = E;
  a.N = N;
  const int words = min(kChunkWords, (N + 31) / 32);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((P + kCluster - 1) / kCluster * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 4 * (size_t)(kScanInts + words + E);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, route_events_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
