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
// before (~7 launches a step, ~1,150 dispatches a frame). Here the chain
// runs inside one warp out of shared memory, and everything that does not
// depend on it runs beside it in parallel:
//  - the slots' reference counts by shared-memory integer atomics (exact in
//    any order); the first free slot a block minimum of indices, the oldest
//    a block minimum of (birth, index) keys;
//  - every (row, corner) pair's squared distance, dx dx + dy dy (built with
//    -fmad=false, so it rounds as the plain version's does), at once; a row
//    keeps the corners under the threshold in a short list, sorted by
//    (distance, index);
//  - warp 0 walks the rows in order, a ballot skipping 32 rows without a
//    candidate at a time; a row's lanes test its list against the claimed
//    flags and the first unclaimed entry is its claim: the plain version's
//    masked argmin, since every entry lies under the threshold and every
//    masked distance (3.4e38) above it;
//  - a row whose list overflows (or every row, where the threshold is above
//    3.4e38) takes that argmin over all the corners in the warp instead, so
//    the kernel is exact for any association distance;
//  - the insertion is two block scans (the corners left over, the free
//    rows); a new row's centre is a copy of its corner, where the plain
//    version sums a one-hot product: the same bits for finite, non-negative
//    corners, which `corner_select` gives (pixel positions, and 0 for the
//    padding). A corner that is not finite would make that product NaN in
//    every row, and is outside what the kernel reproduces.
// The inputs are never written; the outputs go to their own buffers.

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
constexpr float kBig = 3.4e38f;   // the plain version's masked distance
constexpr int kMaxRows = 2048;    // kernels/frame_policy.py::MAX_ROWS (rows and slots)
constexpr int kMaxCorners = 2048;  // kernels/corner_select.py::MAX_CORNERS
constexpr unsigned long long kNone = ~0ull;

static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps, one block");

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
  int P, C, S, max_patches;
  float thresh2;                    // association_distance^2 in float32
};

// byte offsets of the arrays in the block's dynamic shared memory
struct Layout {
  size_t cxy, crank, sel, ld2, lidx, ln, rrank, ref, ok, claimed, row, bytes;
};

__host__ __device__ constexpr Layout layout(int P, int C, int S) {
  Layout l{};
  size_t at = 0;
  l.cxy = at;  // [C, 2] the corners
  at += 8 * (size_t)C;
  l.crank = at;  // [C] the corners left over, counted (inclusive)
  at += 4 * (size_t)C;
  l.sel = at;  // [C] the k-th corner left over
  at += 4 * (size_t)C;
  l.ld2 = at;  // [P, kList] each row's candidates: distance
  at += 4 * (size_t)P * kList;
  l.lidx = at;  // and corner
  at += 4 * (size_t)P * kList;
  l.ln = at;  // [P] each row's candidates found (may pass kList)
  at += 4 * (size_t)P;
  l.rrank = at;  // [P] the free rows, counted (inclusive)
  at += 4 * (size_t)P;
  l.ref = at;  // [S] each slot's live references
  at += 4 * (size_t)S;
  l.ok = at;  // [C] a valid corner (later: valid and left over)
  at += (size_t)C;
  l.claimed = at;  // [C]
  at += (size_t)C;
  l.row = at;  // [P] alive after the eviction (later: free)
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

// the block's minimum of v; every thread calls it and gets it
__device__ unsigned long long block_min(unsigned long long v, unsigned long long* warp_v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) warp_v[warp] = v;
  __syncthreads();
  unsigned long long m = kNone;
  for (int w = 0; w < kWarps; ++w) m = warp_v[w] < m ? warp_v[w] : m;
  __syncthreads();
  return m;
}

// The cumulative count of the set flags [0, n) into rank[i] (the plain
// version's `cumsum`), each thread over a run of consecutive entries;
// returns the total. Every thread must call it; rank is read after a barrier.
__device__ int block_cumsum(const unsigned char* flag, int n, int* rank, int* warp_int) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int v = 0;
  for (int i = lo; i < hi; ++i) v += flag[i];
  int total;
  int run = block_scan<kWarps>(v, warp_int, total);
  for (int i = lo; i < hi; ++i) {
    run += flag[i];
    rank[i] = run;
  }
  return total;
}

// Row i's claim by the plain version's rule over all C corners, in the warp:
// the argmin of the distances with the claimed and the invalid corners at
// kBig (a NaN first, then the lower distance, then the lower index), claimed
// where under the threshold; -1: no claim.
__device__ int masked_argmin(const Args& a, int i, const float* cxy, const unsigned char* ok,
                             const unsigned char* claimed) {
  const int lane = threadIdx.x & 31;
  const float px = a.center[2 * i], py = a.center[2 * i + 1];
  unsigned long long best = kNone;
  for (int c = lane; c < a.C; c += 32) {
    float d = kBig;
    if (ok[c] && !claimed[c]) {
      const float dx = cxy[2 * c] - px, dy = cxy[2 * c + 1] - py;
      d = dx * dx + dy * dy;
    }
    // a distance's order as an unsigned key (it is >= 0): NaN 0, then by bits
    const unsigned key = d != d ? 0u : (d == 0.0f ? 0u : __float_as_uint(d)) + 1u;
    const unsigned long long k = ((unsigned long long)key << 32) | (unsigned)c;
    best = k < best ? k : best;
  }
  best = warp_min(best);
  const unsigned key = (unsigned)(best >> 32);
  if (best == kNone || key == 0u) return -1;  // no corner, or a NaN minimum
  return __uint_as_float(key - 1u) < a.thresh2 ? (int)(best & 0xffffffffu) : -1;
}

__global__ void __launch_bounds__(kThreads) frame_policy_kernel(Args a) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ unsigned long long warp_v[kWarps];
  __shared__ int warp_int[kWarps + 1];
  const int P = a.P, C = a.C, S = a.S;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const Layout L = layout(P, C, S);
  unsigned char* base = reinterpret_cast<unsigned char*>(dyn);
  float* cxy = reinterpret_cast<float*>(base + L.cxy);
  int* crank = reinterpret_cast<int*>(base + L.crank);
  int* sel = reinterpret_cast<int*>(base + L.sel);
  float* ld2 = reinterpret_cast<float*>(base + L.ld2);
  int* lidx = reinterpret_cast<int*>(base + L.lidx);
  int* ln = reinterpret_cast<int*>(base + L.ln);
  int* rrank = reinterpret_cast<int*>(base + L.rrank);
  int* ref = reinterpret_cast<int*>(base + L.ref);
  unsigned char* ok = base + L.ok;
  unsigned char* claimed = base + L.claimed;
  unsigned char* row = base + L.row;

  // the corners into shared memory, the counts zeroed
  for (int c = t; c < C; c += kThreads) {
    cxy[2 * c] = a.corners_xy[2 * c];
    cxy[2 * c + 1] = a.corners_xy[2 * c + 1];
    ok[c] = a.corners_ok[c] != 0;
    claimed[c] = 0;
  }
  for (int s = t; s < S; s += kThreads) ref[s] = 0;
  for (int p = t; p < P; p += kThreads) ln[p] = 0;
  __syncthreads();

  // the gradient slot: the first no live patch references, else the first
  // of the oldest
  for (int p = t; p < P; p += kThreads) {
    const int g = a.grad_slot[p];
    if (a.alive[p] && a.track_id[p] >= 0 && g >= 0 && g < S) atomicAdd(&ref[g], 1);
  }
  __syncthreads();
  unsigned long long first_free = kNone, oldest = kNone;
  for (int s = t; s < S; s += kThreads) {
    if (ref[s] == 0 && (unsigned long long)s < first_free) first_free = (unsigned long long)s;
    const unsigned long long k =
        ((unsigned long long)((unsigned)a.slot_birth[s] ^ 0x80000000u) << 32) | (unsigned)s;
    oldest = k < oldest ? k : oldest;
  }
  first_free = block_min(first_free, warp_v);
  oldest = block_min(oldest, warp_v);
  const bool has_free = first_free != kNone;
  const int slot = has_free ? (int)first_free : (int)(oldest & 0xffffffffu);

  // eviction
  for (int p = t; p < P; p += kThreads) {
    const bool alive = a.alive[p] != 0;
    const bool ev = !has_free && alive && a.grad_slot[p] == slot;
    a.evict[p] = ev;
    row[p] = alive && !ev;
  }
  __syncthreads();

  // each live row's candidates: the valid corners under the threshold
  const bool lists = a.thresh2 <= kBig;
  if (lists) {
    const int pairs = P * C;
    for (int q = t; q < pairs; q += kThreads) {
      const int p = q / C, c = q - p * C;
      if (!row[p] || !ok[c]) continue;
      const float dx = cxy[2 * c] - a.center[2 * p], dy = cxy[2 * c + 1] - a.center[2 * p + 1];
      const float d2 = dx * dx + dy * dy;
      if (d2 < a.thresh2) {
        const int k = atomicAdd(&ln[p], 1);
        if (k < kList) {
          ld2[p * kList + k] = d2;
          lidx[p * kList + k] = c;
        }
      }
    }
    __syncthreads();
    for (int p = t; p < P; p += kThreads) {  // sorted by (distance, index)
      const int n = min(ln[p], kList);
      float* d = ld2 + p * kList;
      int* idx = lidx + p * kList;
      for (int i = 1; i < n; ++i) {
        const float dv = d[i];
        const int iv = idx[i];
        int j = i - 1;
        while (j >= 0 && (d[j] > dv || (d[j] == dv && idx[j] > iv))) {
          d[j + 1] = d[j];
          idx[j + 1] = idx[j];
          --j;
        }
        d[j + 1] = dv;
        idx[j + 1] = iv;
      }
    }
  }
  __syncthreads();

  // greedy association: warp 0 walks the rows in order
  if (warp == 0) {
    for (int r0 = 0; r0 < P; r0 += 32) {
      const int r = r0 + lane;
      unsigned todo = __ballot_sync(kFull, r < P && row[r] && (!lists || ln[r] > 0));
      while (todo) {
        const int i = r0 + __ffs(todo) - 1;
        todo &= todo - 1;
        int j = -1;
        const int n = lists ? ln[i] : kList + 1;
        if (n <= kList) {
          const unsigned m = __ballot_sync(kFull, lane < n && !claimed[lidx[i * kList + lane]]);
          if (m) j = lidx[i * kList + __ffs(m) - 1];
        } else {
          j = masked_argmin(a, i, cxy, ok, claimed);
        }
        if (lane == 0 && j >= 0) claimed[j] = 1;
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // insertion: the k-th corner left over into the k-th free row
  for (int c = t; c < C; c += kThreads) ok[c] = ok[c] && !claimed[c];
  for (int p = t; p < P; p += kThreads) row[p] = !row[p];
  __syncthreads();
  const int n_sel = block_cumsum(ok, C, crank, warp_int);
  const int n_free = block_cumsum(row, P, rrank, warp_int);
  for (int c = t; c < C; c += kThreads)
    if (ok[c]) sel[crank[c] - 1] = c;
  __syncthreads();
  const int next_tid = *a.next_tid, frame_no = *a.frame_no;
  const int budget = max(0, a.max_patches - (P - n_free));
  const int k_max = min(budget, n_sel);
  for (int p = t; p < P; p += kThreads) {
    const bool nm = row[p] && rrank[p] <= k_max;
    a.new_mask[p] = nm;
    a.new_tid[p] = nm ? (int)((unsigned)next_tid + (unsigned)(rrank[p] - 1)) : -1;
    const int c = nm ? sel[rrank[p] - 1] : 0;
    a.new_center[2 * p] = nm ? cxy[2 * c] : 0.0f;
    a.new_center[2 * p + 1] = nm ? cxy[2 * c + 1] : 0.0f;
  }
  for (int s = t; s < S; s += kThreads)
    a.slot_birth_out[s] = s == slot ? frame_no : a.slot_birth[s];
  if (t == 0) {
    const int n_new = min(k_max, n_free);
    *a.slot = slot;
    *a.n_new = n_new;
    *a.next_tid_out = (int)((unsigned)next_tid + (unsigned)n_new);
    *a.frame_no_out = (int)((unsigned)frame_no + 1u);
  }
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
