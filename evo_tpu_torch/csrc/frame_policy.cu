// The tracker's per-frame policy in one launch of one block: gradient-slot
// allocation and eviction, greedy association of the frame's corners with
// the live patches, insertion of the corners left over, and the policy's
// new state.
//
// Replaces `evo_tpu/tracker/policy.py::frame_policy` (:125; its association
// `fori_loop` :160-166): XLA device code, no Pallas kernel. Its plain
// PyTorch version is `evo_tpu_torch/tracker/policy.py::frame_policy_ref`,
// whose rules this file keeps to the bit: the slot is the first one no live
// patch references, else the first of the oldest (argmax / argmin take the
// first of equal values); each live row, in row order, claims its nearest
// unclaimed valid corner closer than the association distance (the masked
// argmin over the corners, ties to the lower index, a NaN distance winning
// and then claiming nothing); the k-th corner left over goes into the k-th
// free row, up to the live cap.
//
// What bounds it: latency. Its data are a few KB (128 rows, 100 corners on
// the main path) and its work a few thousand compares, but the plain
// version's association is a chain of P row steps, each waiting on the one
// before. Here:
//  - every input is staged in shared memory in one round of loads; the
//    slots' reference counts by shared-memory integer atomics (exact in any
//    order); the first free slot and the oldest in one block reduction;
//  - a thread a row builds the row's candidate list: it tests the corners
//    8 at a time in index order (each read by the warp's lanes at once, a
//    broadcast; an invalid one staged as NaN) and inserts those under the
//    threshold into a list of 8 sorted by (distance, index), each squared
//    distance dx dx + dy dy (built with -fmad=false, so it rounds as the
//    plain version's does). The first unclaimed entry of the sorted list
//    is the plain version's masked argmin, since every entry lies under
//    the threshold and every masked distance (3.4e38) above it;
//  - the association in conflict waves: a row can only claim a corner of
//    its list, so its claim waits only on the earlier rows that list one of
//    its corners. A wave resolves every pending row that is, for each of its
//    corners, the first pending row listing it (found by shared atomic
//    minima), all at once: rows resolved together share no corner, and an
//    earlier row listing a corner is always resolved first, so the claims
//    are the serial walk's. Each wave ends in a barrier; the waves are as
//    many as the longest chain of rows sharing corners, not P;
//  - a row whose list overflows (more than 8 candidates) may claim a corner
//    off its list: it waits for every earlier row, every later row waits for
//    it, and it takes the exact argmin over all the corners in warp 0.
//    Where the threshold lies above 3.4e38 every live row is such a row,
//    and the waves resolve them one at a time, in row order;
//  - the insertion is one block scan of the corners left over and the free
//    rows together (two 16-bit counts in one int); a new row's centre is a
//    copy of its corner, where the plain version sums a one-hot product: the
//    same bits for finite, non-negative corners, which `corner_select` gives
//    (pixel positions, and 0 for the padding). A corner that is not finite
//    would make that product NaN in every row, and is outside what the
//    kernel reproduces.
// The inputs are never written; the outputs go to their own buffers.
//
// The clock build (-DEVO_FP_CLOCKS, a library of its own) writes the
// block's cycles of each stage into `clocks` [kStages + 1] (`Stage`,
// `kernels.frame_policy.STAGES`) and, after them, the number of waves the
// association ran (`kernels.frame_policy.CLOCK_SLOTS`); the plain build
// ignores the pointer.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <string.h>

#include "block_scan.cuh"

#include <mutex>

#ifndef EVO_FP_THREADS
#define EVO_FP_THREADS 512  // the emulated tests build it with fewer
#endif

namespace {

constexpr int kThreads = EVO_FP_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kList = 8;          // a row's candidates kept in its list
constexpr int kRowStep = 8;       // corners a row's thread tests at once
constexpr float kBig = 3.4e38f;   // the plain version's masked distance
constexpr int kMaxRows = 2048;    // kernels/frame_policy.py::MAX_ROWS (rows and slots)
constexpr int kMaxCorners = 2048;  // kernels/corner_select.py::MAX_CORNERS
constexpr unsigned long long kNone = ~0ull;
constexpr int kNoRow = 0x7fffffff;
// a row's state in the waves
constexpr unsigned char kDone = 0, kPending = 1, kResolved = 2;

static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps, one block");
static_assert(kMaxRows < 65536 && kMaxCorners < 65536, "the insertion's 16-bit counts");

// Stage clock (-DEVO_FP_CLOCKS only): thread 0 adds the clock64() cycles
// since the previous mark into a stage's bin; each MARK comes after a
// barrier, so a stage's time is its slowest thread's
enum Stage { kLoad, kSlots, kLists, kWaves, kInsert, kTotal, kStages };
#ifdef EVO_FP_CLOCKS
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
  const unsigned char* alive;       // [P] the table's view
  const float* center;              // [P, 2]
  const int* track_id;              // [P]
  const int* grad_slot;             // [P]
  const float* corners_xy;          // [C, 2]
  const unsigned char* corners_ok;  // [C]
  const int* slot_birth;            // [S] the state
  const int* next_tid;              // []
  const int* frame_no;              // []
  int* slot;                        // [] the decisions
  unsigned char* evict;             // [P]
  unsigned char* new_mask;          // [P]
  float* new_center;                // [P, 2]
  int* new_tid;                     // [P]
  int* n_new;                       // []
  int* slot_birth_out;              // [S] the new state
  int* next_tid_out;                // []
  int* frame_no_out;                // []
  long long* clocks;                // [kStages + 1] the clock build's, or null
  int P, C, S, max_patches;
  float thresh2;                    // association_distance^2 in float32
};

// byte offsets of the arrays in the block's dynamic shared memory
struct Layout {
  size_t cxy, pxy, grad, ld2, lidx, ln, fu, sel, rrank, ref, birth, ok, claimed, alive, todo,
      bytes;
};

__host__ __device__ constexpr Layout layout(int P, int C, int S) {
  Layout l{};
  size_t at = 0;
  l.cxy = at;  // [C, 2] the corners
  at += 8 * (size_t)C;
  l.pxy = at;  // [P, 2] the rows' centres
  at += 8 * (size_t)P;
  l.grad = at;  // [P] the rows' gradient slots
  at += 4 * (size_t)P;
  l.ld2 = at;  // [P, kList] each row's candidates, sorted: distance
  at += 4 * (size_t)P * kList;
  l.lidx = at;  // and corner
  at += 4 * (size_t)P * kList;
  l.ln = at;  // [P] each row's candidates found (kList + 1: more than kList)
  at += 4 * (size_t)P;
  l.fu = at;  // [C] the first pending row listing the corner, in a wave
  at += 4 * (size_t)C;
  l.sel = at;  // [C] the k-th corner left over
  at += 4 * (size_t)C;
  l.rrank = at;  // [P] the free rows, counted (inclusive)
  at += 4 * (size_t)P;
  l.ref = at;  // [S] each slot's live references
  at += 4 * (size_t)S;
  l.birth = at;  // [S] the slots' births
  at += 4 * (size_t)S;
  l.ok = at;  // [C] a valid corner
  at += (size_t)C;
  l.claimed = at;  // [C]
  at += (size_t)C;
  l.alive = at;  // [P] the view's: bit 0 alive, bit 1 a track (track_id >= 0)
  at += (size_t)P;
  l.todo = at;  // [P] the row's state in the waves
  at += (size_t)P;
  l.bytes = (at + 15) / 16 * 16;
  return l;
}

// the largest view the launch takes fits one block's shared memory (232,448
// bytes on the card)
static_assert(layout(kMaxRows, kMaxCorners, kMaxRows).bytes <= 232448, "shared memory");

__device__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// A distance's order as an unsigned key (it is >= 0 or NaN): NaN 0, then by
// bits, +0 and -0 alike
__device__ unsigned dist_key(float d) {
  return d != d ? 0u : (d == 0.0f ? 0u : __float_as_uint(d)) + 1u;
}

// Row i's claim by the plain version's rule over all C corners, in the warp:
// the argmin of the distances with the claimed and the invalid corners at
// kBig (a NaN first, then the lower distance, then the lower index), claimed
// where under the threshold; -1: no claim.
__device__ int masked_argmin(const Args& a, const float* pxy, int i, const float* cxy,
                             const unsigned char* ok, const unsigned char* claimed) {
  const int lane = threadIdx.x & 31;
  const float px = pxy[2 * i], py = pxy[2 * i + 1];
  unsigned long long best = kNone;
  for (int c = lane; c < a.C; c += 32) {
    float d = kBig;
    if (ok[c] && !claimed[c]) {
      const float dx = cxy[2 * c] - px, dy = cxy[2 * c + 1] - py;
      d = dx * dx + dy * dy;
    }
    const unsigned long long k = ((unsigned long long)dist_key(d) << 32) | (unsigned)c;
    best = k < best ? k : best;
  }
  best = warp_min(best);
  const unsigned key = (unsigned)(best >> 32);
  if (best == kNone || key == 0u) return -1;  // no corner, or a NaN minimum
  return __uint_as_float(key - 1u) < a.thresh2 ? (int)(best & 0xffffffffu) : -1;
}

__global__ void __launch_bounds__(kThreads) frame_policy_kernel(Args a) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ unsigned long long warp_v[2][kWarps];
  __shared__ int warp_int[kWarps + 1];
  __shared__ int min_pending, min_over;  // a wave's first pending row and overflowing row
  __shared__ int next_tid, frame_no;
  const int P = a.P, C = a.C, S = a.S;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const Layout L = layout(P, C, S);
  unsigned char* base = reinterpret_cast<unsigned char*>(dyn);
  float* cxy = reinterpret_cast<float*>(base + L.cxy);
  float* pxy = reinterpret_cast<float*>(base + L.pxy);
  int* grad = reinterpret_cast<int*>(base + L.grad);
  float* ld2 = reinterpret_cast<float*>(base + L.ld2);
  int* lidx = reinterpret_cast<int*>(base + L.lidx);
  int* ln = reinterpret_cast<int*>(base + L.ln);
  int* fu = reinterpret_cast<int*>(base + L.fu);
  int* sel = reinterpret_cast<int*>(base + L.sel);
  int* rrank = reinterpret_cast<int*>(base + L.rrank);
  int* ref = reinterpret_cast<int*>(base + L.ref);
  int* birth = reinterpret_cast<int*>(base + L.birth);
  unsigned char* ok = base + L.ok;
  unsigned char* claimed = base + L.claimed;
  unsigned char* alive = base + L.alive;
  unsigned char* todo = base + L.todo;
#ifdef EVO_FP_CLOCKS
  long long bins[kStages] = {}, last = clock64();
  const long long start = last;
  long long waves = 0;  // waves that had a pending row
#endif

  // every input into shared memory, in one round of loads; the counts
  // zeroed; an invalid corner's position NaN, so its distance is no
  // candidate's (every other reader of a position checks `ok` first)
  for (int c = t; c < C; c += kThreads) {
    ok[c] = a.corners_ok[c] != 0;
    cxy[2 * c] = ok[c] ? a.corners_xy[2 * c] : NAN;
    cxy[2 * c + 1] = ok[c] ? a.corners_xy[2 * c + 1] : NAN;
    claimed[c] = 0;
    fu[c] = kNoRow;
  }
  for (int p = t; p < P; p += kThreads) {
    pxy[2 * p] = a.center[2 * p];
    pxy[2 * p + 1] = a.center[2 * p + 1];
    grad[p] = a.grad_slot[p];
    alive[p] = (a.alive[p] != 0) | (a.track_id[p] >= 0) << 1;
  }
  for (int s = t; s < S; s += kThreads) {
    ref[s] = 0;
    birth[s] = a.slot_birth[s];
  }
  if (t == 0) {
    min_pending = min_over = kNoRow;
    next_tid = *a.next_tid;
    frame_no = *a.frame_no;
  }
  __syncthreads();
  MARK(kLoad);

  // the gradient slot: the first no live patch references, else the first
  // of the oldest
  for (int p = t; p < P; p += kThreads) {
    const int g = grad[p];
    if (alive[p] == 3 && g >= 0 && g < S) atomicAdd(&ref[g], 1);
  }
  __syncthreads();
  unsigned long long first_free = kNone, oldest = kNone;
  for (int s = t; s < S; s += kThreads) {
    if (ref[s] == 0 && (unsigned long long)s < first_free) first_free = (unsigned long long)s;
    const unsigned long long k =
        ((unsigned long long)((unsigned)birth[s] ^ 0x80000000u) << 32) | (unsigned)s;
    oldest = k < oldest ? k : oldest;
  }
  first_free = warp_min(first_free);
  oldest = warp_min(oldest);
  if (lane == 0) {
    warp_v[0][warp] = first_free;
    warp_v[1][warp] = oldest;
  }
  __syncthreads();
  first_free = warp_min(lane < kWarps ? warp_v[0][lane] : kNone);
  oldest = warp_min(lane < kWarps ? warp_v[1][lane] : kNone);
  const bool has_free = first_free != kNone;
  const int slot = has_free ? (int)first_free : (int)(oldest & 0xffffffffu);
  for (int p = t; p < P; p += kThreads)
    a.evict[p] = !has_free && (alive[p] & 1) && grad[p] == slot;
  MARK(kSlots);

  // each live row's candidates, a thread a row: the valid corners under the
  // threshold, in index order into a list sorted by (distance, index); a
  // row with more than kList takes the argmin over all corners instead
  const bool lists = a.thresh2 <= kBig;
  for (int p = t; p < P; p += kThreads) {
    const bool live = (alive[p] & 1) && (has_free || grad[p] != slot);
    int n = 0;
    if (live && !lists) {
      n = kList + 1;  // every live row takes the argmin over all corners
    } else if (live) {
      const float px = pxy[2 * p], py = pxy[2 * p + 1];
      const float2* cxy2 = reinterpret_cast<const float2*>(cxy);
      float* d = ld2 + p * kList;
      int* idx = lidx + p * kList;
      for (int c0 = 0; c0 < C && n <= kList; c0 += kRowStep) {
        // kRowStep corners' tests at once (their loads issued together),
        // then the rare hits into the list
        unsigned hits = 0;
#pragma unroll
        for (int k = 0; k < kRowStep; ++k) {
          const float2 v = cxy2[min(c0 + k, C - 1)];
          const float dx = v.x - px, dy = v.y - py;
          if (c0 + k < C && dx * dx + dy * dy < a.thresh2) hits |= 1u << k;
        }
        for (; hits && n <= kList; hits &= hits - 1) {
          if (n == kList) {
            n = kList + 1;
            break;
          }
          const int c = c0 + __ffs(hits) - 1;
          const float dx = cxy[2 * c] - px, dy = cxy[2 * c + 1] - py;
          const float d2 = dx * dx + dy * dy;
          int j = n++;  // after the equal distances: their corners come first
          for (; j > 0 && d[j - 1] > d2; --j) {
            d[j] = d[j - 1];
            idx[j] = idx[j - 1];
          }
          d[j] = d2;
          idx[j] = c;
        }
      }
    }
    ln[p] = n;
    todo[p] = n > 0 ? kPending : kDone;
  }
  __syncthreads();
  MARK(kLists);

  bool more = true;
  while (more) {
    // a thread a row: the first pending row listing each corner, the
    // first pending row and the first pending row whose list overflows
    for (int p = t; p < P; p += kThreads) {
      if (todo[p] != kPending) continue;
      const int n = ln[p];
      atomicMin(&min_pending, p);
      if (n > kList) atomicMin(&min_over, p);
      else
        for (int e = 0; e < n; ++e) atomicMin(&fu[lidx[p * kList + e]], p);
    }
    __syncthreads();
    // the rows first for all of their corners (and before the first
    // overflowing row) claim; an overflowing row claims, in warp 0, when
    // it is the first pending row, alone (its list is not all written)
    const int first = min_pending, over = min_over;
#ifdef EVO_FP_CLOCKS
    if (t == 0 && first != kNoRow) ++waves;
#endif
    for (int p = t; p < P; p += kThreads) {
      if (todo[p] != kPending || p >= over) continue;
      const int n = ln[p];
      const int* li = lidx + p * kList;
      bool ready = true;
      for (int e = 0; e < n; ++e) ready = ready && fu[li[e]] == p;
      if (!ready) continue;
      int j = -1;
      for (int e = 0; e < n && j < 0; ++e)
        if (!claimed[li[e]]) j = li[e];
      if (j >= 0) claimed[j] = 1;
      todo[p] = kResolved;
    }
    if (warp == 0 && over != kNoRow && over == first) {
      const int j = masked_argmin(a, pxy, first, cxy, ok, claimed);
      if (lane == 0) {
        if (j >= 0) claimed[j] = 1;
        todo[first] = kResolved;
      }
    }
    __syncthreads();
    // the minima cleared for the next wave
    bool left = false;
    for (int p = t; p < P; p += kThreads) {
      const unsigned char st = todo[p];
      if (st == kDone) continue;
      const int n = ln[p];
      if (n <= kList)
        for (int e = 0; e < n; ++e) fu[lidx[p * kList + e]] = kNoRow;
      if (st == kPending) left = true;
      else todo[p] = kDone;
    }
    if (t == 0) min_pending = min_over = kNoRow;
    more = __syncthreads_or(left);
  }
  MARK(kWaves);

  // insertion: the k-th corner left over into the k-th free row. One scan
  // counts both: corners in the high 16 bits, free rows in the low
  const int items = max(C, P);
  const int per = (items + kThreads - 1) / kThreads;
  const int lo = min(items, t * per), hi = min(items, lo + per);
  int v = 0;
  for (int i = lo; i < hi; ++i) {
    const bool left_c = i < C && ok[i] && !claimed[i];
    const bool free_r = i < P && !((alive[i] & 1) && (has_free || grad[i] != slot));
    v += ((int)left_c << 16) | (int)free_r;
  }
  int total;
  int run = block_scan<kWarps>(v, warp_int, total);
  for (int i = lo; i < hi; ++i) {
    const bool left_c = i < C && ok[i] && !claimed[i];
    const bool free_r = i < P && !((alive[i] & 1) && (has_free || grad[i] != slot));
    run += ((int)left_c << 16) | (int)free_r;
    if (left_c) sel[(run >> 16) - 1] = i;
    if (i < P) rrank[i] = free_r ? (run & 0xffff) : 0;
  }
  __syncthreads();
  const int n_sel = total >> 16, n_free = total & 0xffff;
  const int budget = max(0, a.max_patches - (P - n_free));
  const int k_max = min(budget, n_sel);
  for (int p = t; p < P; p += kThreads) {
    const int r = rrank[p];
    const bool nm = r > 0 && r <= k_max;
    a.new_mask[p] = nm;
    a.new_tid[p] = nm ? (int)((unsigned)next_tid + (unsigned)(r - 1)) : -1;
    const int c = nm ? sel[r - 1] : 0;
    a.new_center[2 * p] = nm ? cxy[2 * c] : 0.0f;
    a.new_center[2 * p + 1] = nm ? cxy[2 * c + 1] : 0.0f;
  }
  for (int s = t; s < S; s += kThreads)
    a.slot_birth_out[s] = s == slot ? frame_no : birth[s];
  if (t == 0) {
    const int n_new = min(k_max, n_free);
    *a.slot = slot;
    *a.n_new = n_new;
    *a.next_tid_out = (int)((unsigned)next_tid + (unsigned)n_new);
    *a.frame_no_out = (int)((unsigned)frame_no + 1u);
  }
  MARK(kInsert);
#ifdef EVO_FP_CLOCKS
  if (t == 0 && a.clocks) {
    bins[kTotal] = last - start;
    for (int k = 0; k < kStages; ++k) a.clocks[k] = bins[k];
    a.clocks[kStages] = waves;
  }
#endif
}

std::mutex attr_lock;
bool attr_set = false;

}  // namespace

// One launch of one block. `ptrs` holds the Args pointers in their order
// (`kernels/frame_policy.py::POINTERS`). P and S at most kMaxRows, C at most
// kMaxCorners, S at least 1.
extern "C" int evo_frame_policy(const void* const* ptrs, int P, int C, int S, int max_patches,
                                float thresh2, void* stream) {
  if (P < 0 || C < 0 || S < 1 || P > kMaxRows || S > kMaxRows || C > kMaxCorners)
    return (int)cudaErrorInvalidValue;
  Args a;
  memcpy(&a, ptrs, offsetof(Args, P));
  a.P = P;
  a.C = C;
  a.S = S;
  a.max_patches = max_patches;
  a.thresh2 = thresh2;
  {
    std::lock_guard<std::mutex> hold(attr_lock);
    if (!attr_set) {
      const cudaError_t err =
          cudaFuncSetAttribute(frame_policy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)layout(kMaxRows, kMaxCorners, kMaxRows).bytes);
      if (err != cudaSuccess) return (int)err;
      attr_set = true;
    }
  }
  const size_t smem = layout(P, C, S).bytes;
  frame_policy_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
