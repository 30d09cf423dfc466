// Event routing in one launch, a block a patch: each event of a sub-batch is
// appended to the ring of every live patch whose 25 x 25 rect holds it, and
// each ring keeps its patch's newest E events.
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
// What bounds it: latency and the events' reads. A sub-batch (~5,000 events,
// 4,096-multiples in dense windows) is read by every patch's block from L2,
// twice: once to count the patch's hits (the threshold of the kept ranks
// needs the total), once to rank them and write the kept ones. A thread
// takes a run of kRun consecutive events (its loads issued together), so a
// block takes kChunk events between two block scans of the runs' counts,
// which give each hit its rank. A block writes its patch's
// whole new ring row, the old entries where no kept hit lands and the kept
// hits where they do, so the table stays functional (the input is never
// written) without a copy of its own, and the slots each get one write. No
// host read: the plain version's `nonzero` waited on the card once a
// sub-batch.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

#include "block_scan.cuh"

#ifndef EVO_RE_THREADS
#define EVO_RE_THREADS 256  // the emulated tests build it with fewer
#endif
#ifndef EVO_RE_RUN
#define EVO_RE_RUN 16  // and with longer runs
#endif

namespace {

constexpr int kThreads = EVO_RE_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = EVO_RE_RUN;         // consecutive events a thread takes
constexpr int kChunk = kThreads * kRun;  // events a block takes at a time
constexpr unsigned kFull = 0xffffffffu;
constexpr float kExtent = 12.0f;  // patch_state.PATCH_EXTENT
constexpr int kRing = 4;          // ev_t, ev_x, ev_y, ev_p

static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps, one block");
static_assert(kRun >= 1 && kRun <= 32, "a run's hits are one 32-bit mask");

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
  int P, E, N;
};

// The hits among events [lo, lo + kRun) of the sub-batch as a mask, bit j
// for event lo + j: |ex - cx| <= 12, |ey - cy| <= 12 and valid. Every load of
// the run is issued before any of its compares, none waiting on another.
__device__ unsigned run_hits(const Args& a, int lo, float cx, float cy) {
  unsigned char valid[kRun];
  float ex[kRun], ey[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int i = min(lo + j, a.N - 1);  // past the end: the last event, not counted
    const unsigned char mask = a.mask[i];
    valid[j] = lo + j < a.N ? mask : 0;
    ex[j] = a.ev[1][i];
    ey[j] = a.ev[2][i];
  }
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j)
    if (valid[j] && fabsf(ex[j] - cx) <= kExtent && fabsf(ey[j] - cy) <= kExtent) m |= 1u << j;
  return m;
}

__device__ int py_mod(long long v, int m) {
  const long long r = v % m;
  return (int)(r < 0 ? r + m : r);
}

__global__ void __launch_bounds__(kThreads) route_events_kernel(Args a) {
  __shared__ int warp_int[kWarps + 1];
  const int p = blockIdx.x, t = threadIdx.x;
  const int E = a.E, N = a.N;
  const float cx = a.center[2 * p], cy = a.center[2 * p + 1];

  // pass 1: the patch's hits
  int n = 0;
  if (a.alive[p])
    for (int b = 0; b < N; b += kChunk) n += __popc(run_hits(a, b + t * kRun, cx, cy));
  int tot;
  block_scan<kWarps>(n, warp_int, tot);

  // the old entries where no kept hit lands: the kept hits fill `kept`
  // consecutive slots (mod E) from `first`
  const int kept = min(tot, E);
  const long long count = a.ev_count[p];
  const int first = py_mod(count + tot - kept, E);
  const size_t at = (size_t)p * E;
  for (int j = t; j < E; j += kThreads)
    if (py_mod((long long)j - first, E) >= kept)
      for (int k = 0; k < kRing; ++k) a.ring_out[k][at + j] = a.ring[k][at + j];

  // pass 2: each hit's rank (the hits before its run), the kept hits into
  // their slots
  if (tot > 0) {
    int before = 0;  // hits in the chunks before
    for (int b = 0; b < N; b += kChunk) {
      const int lo = b + t * kRun;
      unsigned m = run_hits(a, lo, cx, cy);
      int chunk;
      int rank = before + block_scan<kWarps>(__popc(m), warp_int, chunk);
      for (; m; m &= m - 1) {
        const int i = lo + __ffs(m) - 1;
        if (++rank > tot - E) {
          const int s = py_mod(count + rank - 1, E);
          for (int k = 0; k < kRing; ++k) a.ring_out[k][at + s] = a.ev[k][i];
        }
      }
      before += chunk;
    }
  }
  if (t == 0) {
    a.ev_count_out[p] = (int)((unsigned)a.ev_count[p] + (unsigned)tot);
    a.counter_out[p] = (int)((unsigned)a.counter[p] + (unsigned)tot);
  }
}

}  // namespace

// One launch over the P patches. `ptrs` holds the Args pointers in their
// order (`kernels/route_events.py::POINTERS`). E at least 1.
extern "C" int evo_route_events(const void* const* ptrs, int P, int E, int N, void* stream) {
  if (P < 0 || E < 1 || N < 0) return (int)cudaErrorInvalidValue;
  if (P == 0) return (int)cudaSuccess;
  Args a;
  memcpy(&a, ptrs, offsetof(Args, P));
  a.P = P;
  a.E = E;
  a.N = N;
  route_events_kernel<<<P, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
