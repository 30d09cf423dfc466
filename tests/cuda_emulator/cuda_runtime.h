// A stand-in for <cuda_runtime.h> that lets g++ compile a CUDA source of
// the package and run its kernels on the CPU, for tests without a card
// (`tests/test_torch_align_emulated.py`, `tests/test_torch_comp_emulated.py`,
// `tests/test_torch_vo_emulated.py`, `tests/test_torch_frame_emulated.py`,
// `tests/test_torch_policy_emulated.py`). It is not a CUDA implementation:
// it covers what `evo_tpu_torch/csrc/`'s `align_step.cu`, `comp_tile.cu`,
// `comp_step.cu`, `localize.cu`, `ba_solve.cu`, `frame_maps.cu`,
// `corner_select.cu`, `frame_rows.cu`, `frame_policy.cu` and
// `route_events.cu` use, and no more.
//
// A launch runs the grid's clusters one after another (a `<<<...>>>` launch:
// clusters of one block); the blocks of a cluster run side by side, each
// thread of each block as a fiber (a context with a stack of its own) on
// the launching thread. The fibers take turns in thread order, each running
// until it waits at a barrier or ends, so a launch takes one core and its
// barriers cost a context switch a thread, where a thread of the system
// each would wait on the scheduler; a launch whose threads all wait at
// barriers the others never reach aborts. `__shared__` variables are
// function statics, so the threads of every running block share them: a
// kernel launched in clusters of more than one block keeps its shared state
// in its dynamic shared memory. `__syncthreads` is a barrier over the
// block, `cluster.sync()` (`cooperative_groups.h` beside this file) one over
// the cluster; the warp shuffles and ballots exchange values through an
// array and one barrier of the warp (two halves, which the warp's exchanges
// take in turn, so a lane writes one while the others may still read the
// other), and `__syncwarp` is one such barrier; `atomicAdd` and `atomicMin`
// take a mutex. A launch's dynamic shared memory is a buffer of the block,
// which `evo_emu::dynamic_smem()` returns (the tests rewrite `extern
// __shared__ __align__(16) float name[];` into a call of it), filled with
// quiet NaNs as the card leaves it undefined: a float read before it is
// written is NaN, and an index so read (2,143,289,344) points gigabytes
// past the buffer, so a read of what was never written shows here too;
// `map_shared_rank` maps a pointer into it to the same place in another
// block of the cluster.
// Compile with `g++ -std=c++20 -ffp-contract=off` so that each product and
// sum rounds on its own, as the kernels' `-fmad=false` build does; an
// explicit fmaf() is one rounding on both.
//
// The test rewrites each `kernel<<<grid, block, smem, stream>>>(args);` of
// the source into `evo_emu::launch(grid, block, smem, stream, [&] {
// kernel(args); });`, and each `cudaLaunchKernelEx(&config, kernel, args);`
// into `evo_emu::launch_ex(&config, [&] { kernel(args); });`, before it
// compiles it.

#pragma once

#include <sys/mman.h>
#include <ucontext.h>

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <math.h>
#include <limits>
#include <memory>
#include <mutex>
#include <type_traits>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)

struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
inline float2 make_float2(float x, float y) { return float2{x, y}; }

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned x_, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 11
};
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes = 0;
  cudaStream_t stream = nullptr;
  cudaLaunchAttribute* attrs = nullptr;
  unsigned numAttrs = 0;
};

// the running fiber's built-in indices (variables, not macros, so that a
// member of the same name, as `cudaLaunchConfig_t::gridDim`, stays free)
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace evo_emu {

struct Block;

// a thread of the launch
struct Fiber {
  ucontext_t context;
  Block* block = nullptr;
  dim3 thread, index;  // its threadIdx and blockIdx
  // its count of its warp's exchanges and of its block's `__syncthreads_or`
  // calls (every lane, and every thread, makes the same calls in the same
  // order)
  unsigned exchanges = 0, or_calls = 0;
  bool done = false;
};

inline thread_local Fiber* self = nullptr;       // the running fiber
inline thread_local ucontext_t* home = nullptr;  // the launch's own context
// arrivals at barriers and ends of fibers: a turn of every waiting fiber
// that adds none is a deadlock
inline thread_local unsigned long long steps = 0;

// the running fiber's turn ends; the launch's next fiber takes its turn
inline void yield() { swapcontext(&self->context, home); }

// A barrier of `count` threads: the last to arrive releases the others and
// goes on; the others yield their turns until it has.
struct Barrier {
  explicit Barrier(std::ptrdiff_t count) : count(count) {}
  void arrive_and_wait() {
    ++steps;
    const unsigned long long gen = generation;
    if (++arrived == count) {
      arrived = 0;
      ++generation;
      return;
    }
    while (generation == gen) yield();
  }
  std::ptrdiff_t count, arrived = 0;
  unsigned long long generation = 0;
};

struct Cluster;

struct Block {
  explicit Block(int threads)
      : sync(threads), exchange(2 * (size_t)threads) {
    for (int w = 0; w < (threads + 31) / 32; ++w)
      warps.emplace_back(new Barrier(threads - 32 * w < 32 ? threads - 32 * w : 32));
  }
  Barrier sync;
  std::vector<std::unique_ptr<Barrier>> warps;
  // one 8-byte slot a thread in each half: the warp's exchanges alternate
  // between them
  std::vector<unsigned long long> exchange;
  std::mutex atomic;
  // `__syncthreads_or`'s predicates: its calls take the three in turn
  std::atomic<int> any[3] = {0, 0, 0};
  std::vector<float> dynamic;  // the launch's dynamic shared memory
  Cluster* cluster = nullptr;
  unsigned rank = 0;  // in its cluster
};

// the blocks of a cluster, which run side by side, and their barrier
struct Cluster {
  Cluster(unsigned blocks, int threads) : sync((std::ptrdiff_t)blocks * threads) {}
  Barrier sync;
  std::vector<Block*> blocks;
};

inline thread_local Block* block = nullptr;  // the block of the running fiber

// The half of the exchange array for the warp's next exchange. A lane
// writes a half only after the barrier of the exchange between, which every
// lane reaches after its reads of the half's last exchange, so one barrier
// an exchange is enough.
inline unsigned long long* exchange_half() {
  return block->exchange.data() + (self->exchanges++ & 1) * (block->exchange.size() / 2);
}

template <class T>
T shuffle(T v, int src_lane) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 8 bytes");
  const int t = (int)::threadIdx.x, w = t >> 5;
  unsigned long long* half = exchange_half();
  unsigned long long slot = 0;
  std::memcpy(&slot, &v, sizeof(T));
  half[t] = slot;
  block->warps[w]->arrive_and_wait();
  T out;
  slot = half[(w << 5) | (src_lane & 31)];
  std::memcpy(&out, &slot, sizeof(T));
  return out;
}

// The warp's predicates as a mask, bit l from lane l (every lane of the
// warp takes part).
inline unsigned ballot(bool pred) {
  const int t = (int)::threadIdx.x, w = t >> 5;
  unsigned long long* half = exchange_half();
  half[t] = pred ? 1 : 0;
  block->warps[w]->arrive_and_wait();
  unsigned m = 0;
  const int lanes = (int)block->exchange.size() / 2 - (w << 5);
  for (int l = 0; l < 32 && l < lanes; ++l)
    if (half[(w << 5) | l]) m |= 1u << l;
  return m;
}

// The fibers' stacks, one mapping (committed only where a stack is used),
// each with a page at its low end that faults on an overflow
struct Stacks {
  static constexpr size_t kBytes = size_t(1) << 20, kGuard = 4096;
  explicit Stacks(size_t n) : n(n) {
    void* at = mmap(nullptr, n * kBytes, PROT_READ | PROT_WRITE,
                    MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (at == MAP_FAILED) {
      std::perror("emulated launch: mmap of the threads' stacks");
      std::abort();
    }
    base = static_cast<char*>(at);
    for (size_t i = 0; i < n; ++i) mprotect(base + i * kBytes, kGuard, PROT_NONE);
  }
  ~Stacks() { munmap(base, n * kBytes); }
  char* at(size_t i) const { return base + i * kBytes; }
  size_t n;
  char* base;
};

// what each fiber of the launch runs: the kernel's body
inline thread_local void (*entry)(void*) = nullptr;
inline thread_local void* entry_arg = nullptr;

inline void fiber_main() {
  entry(entry_arg);
  self->done = true;
  ++steps;
  swapcontext(&self->context, home);  // never resumed
}

// The grid's clusters of `cluster` blocks in turn, the blocks of each side by
// side; a grid of more than one row (grid.y) runs its rows in turn.
template <class F>
void launch_clusters(dim3 grid, dim3 threads, size_t smem, unsigned cluster, F&& body) {
  using Body = std::remove_reference_t<F>;
  const size_t n = (size_t)cluster * threads.x;
  const Stacks stacks(n);
  entry = [](void* f) { (*static_cast<Body*>(f))(); };
  entry_arg = const_cast<void*>(static_cast<const void*>(std::addressof(body)));
  ucontext_t launcher;
  home = &launcher;
  ::blockDim = threads;
  ::gridDim = grid;
  for (unsigned row = 0; row < grid.y; ++row)
  for (unsigned first = 0; first < grid.x; first += cluster) {
    Cluster cl(cluster, (int)threads.x);
    std::vector<std::unique_ptr<Block>> blocks;
    for (unsigned r = 0; r < cluster; ++r) {
      blocks.emplace_back(new Block((int)threads.x));
      blocks.back()->dynamic.assign((smem + sizeof(float) - 1) / sizeof(float),
                                      std::numeric_limits<float>::quiet_NaN());
      blocks.back()->cluster = &cl;
      blocks.back()->rank = r;
      cl.blocks.push_back(blocks.back().get());
    }
    std::vector<Fiber> fibers(n);
    for (size_t i = 0; i < n; ++i) {
      Fiber& f = fibers[i];
      f.block = cl.blocks[i / threads.x];
      f.thread = dim3((unsigned)(i % threads.x));
      f.index = dim3(first + (unsigned)(i / threads.x), row);
      getcontext(&f.context);
      f.context.uc_stack.ss_sp = stacks.at(i) + Stacks::kGuard;
      f.context.uc_stack.ss_size = Stacks::kBytes - Stacks::kGuard;
      f.context.uc_link = nullptr;
      makecontext(&f.context, fiber_main, 0);
    }
    for (size_t left = n; left;) {
      const unsigned long long before = steps;
      for (Fiber& f : fibers) {
        if (f.done) continue;
        self = &f;
        block = f.block;
        ::threadIdx = f.thread;
        ::blockIdx = f.index;
        swapcontext(&launcher, &f.context);
        if (f.done) --left;
      }
      if (left && steps == before) {
        std::fprintf(stderr, "emulated launch: its threads wait at barriers that the others "
                             "never reach\n");
        std::abort();
      }
    }
  }
  self = nullptr;
  block = nullptr;
  home = nullptr;
}

template <class F>
void launch(dim3 grid, dim3 threads, size_t smem, cudaStream_t, F&& body) {
  launch_clusters(grid, threads, smem, 1, body);
}

// `cudaLaunchKernelEx` with its cluster attribute (clusters of one block
// without it)
template <class F>
cudaError_t launch_ex(const cudaLaunchConfig_t* config, F&& body) {
  unsigned cluster = 1;
  for (unsigned k = 0; k < config->numAttrs; ++k)
    if (config->attrs[k].id == cudaLaunchAttributeClusterDimension)
      cluster = config->attrs[k].val.clusterDim.x;
  if (cluster < 1 || config->gridDim.x % cluster != 0) return cudaErrorInvalidConfiguration;
  launch_clusters(config->gridDim, config->blockDim, config->dynamicSmemBytes, cluster, body);
  return cudaSuccess;
}

inline float* dynamic_smem() { return block->dynamic.data(); }

}  // namespace evo_emu

inline void __syncthreads() { evo_emu::block->sync.arrive_and_wait(); }
// a barrier of the block that returns whether any thread's predicate held.
// Call k sets predicate k mod 3 and reads it after its barrier; thread 0
// clears predicate (k + 2) mod 3 then: call k - 1 read it before the
// barrier, and call k + 2 sets it only after call k + 1's, which thread 0
// reaches after the clear. So one barrier a call.
inline int __syncthreads_or(int pred) {
  evo_emu::Block* b = evo_emu::block;
  const unsigned k = evo_emu::self->or_calls++ % 3;
  if (pred) b->any[k].store(1);
  b->sync.arrive_and_wait();
  const int any = b->any[k].load();
  if (threadIdx.x == 0) b->any[(k + 2) % 3].store(0);
  return any;
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  evo_emu::block->warps[(int)::threadIdx.x >> 5]->arrive_and_wait();
}

template <class T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  return evo_emu::shuffle(v, ((int)::threadIdx.x & 31) ^ mask);
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return evo_emu::shuffle(v, src);
}
inline unsigned __ballot_sync(unsigned, bool pred) { return evo_emu::ballot(pred); }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }

template <class T>
inline T atomicAdd(T* at, T v) {
  std::lock_guard<std::mutex> hold(evo_emu::block->atomic);
  const T old = *at;
  *at = old + v;
  return old;
}
template <class T>
inline T atomicMin(T* at, T v) {
  std::lock_guard<std::mutex> hold(evo_emu::block->atomic);
  const T old = *at;
  *at = v < old ? v : old;
  return old;
}

// a float's bits and back
inline unsigned __float_as_uint(float v) {
  unsigned u;
  std::memcpy(&u, &v, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float v;
  std::memcpy(&v, &u, sizeof v);
  return v;
}

template <class T>
inline T __ldg(const T* p) { return *p; }

// the card's approximate quotient (a reciprocal of about 1 ulp, times x)
// taken as the exact one; a fused multiply-add rounded once, as on the card
inline float __fdividef(float x, float y) { return x / y; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
// the card's fast exponential (its 2^x unit, within a few ulp) taken as the
// exact one
inline float __expf(float x) { return std::exp(x); }

inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch()).count();
}

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
template <class Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, int, int) { return cudaSuccess; }
// every cluster can be placed: its blocks run as fibers
template <class Kernel>
cudaError_t cudaOccupancyMaxActiveClusters(int* clusters, Kernel, const cudaLaunchConfig_t*) {
  *clusters = 1;
  return cudaSuccess;
}

