// A stand-in for <cuda_runtime.h> that lets g++ compile a CUDA source of
// the package and run its kernels on the CPU, for tests without a card
// (`tests/test_torch_align_emulated.py`). It is not a CUDA implementation:
// it covers what `evo_tpu_torch/csrc/align_step.cu` uses, and no more.
//
// A launch runs the grid's blocks one after another; each block runs as
// one std::thread for each thread of the block. `__shared__` variables are function statics, so
// the threads of the running block share them. `__syncthreads` is a
// std::barrier over the block; the warp shuffles exchange values through an
// array between two barriers of the warp; `atomicAdd` takes a mutex.
// Compile with `g++ -std=c++20 -ffp-contract=off` so that each product and
// sum rounds on its own, as the kernels' `-fmad=false` build does; an
// explicit fmaf() is one rounding on both.
//
// The test rewrites each `kernel<<<grid, block, smem, stream>>>(args);` of
// the source into `evo_emu::launch(grid, block, smem, stream, [&] {
// kernel(args); });` before it compiles it.

#pragma once

#include <barrier>
#include <chrono>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <math.h>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct float2 {
  float x, y;
};

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned x_) : x(x_) {}
};

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0 };

namespace evo_emu {

inline thread_local dim3 thread_idx, block_idx;

struct Block {
  explicit Block(int threads)
      : sync(threads), exchange(threads) {
    for (int w = 0; w < (threads + 31) / 32; ++w)
      warps.emplace_back(new std::barrier<>(threads - 32 * w < 32 ? threads - 32 * w : 32));
  }
  std::barrier<> sync;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<unsigned long long> exchange;  // one 8-byte slot a thread
  std::mutex atomic;
};

inline Block* block = nullptr;  // the running block

template <class T>
T shuffle(T v, int src_lane) {
  static_assert(sizeof(T) <= 8, "a shuffle moves at most 8 bytes");
  const int t = (int)thread_idx.x, w = t >> 5;
  unsigned long long slot = 0;
  std::memcpy(&slot, &v, sizeof(T));
  block->exchange[t] = slot;
  block->warps[w]->arrive_and_wait();
  T out;
  slot = block->exchange[(w << 5) | (src_lane & 31)];
  std::memcpy(&out, &slot, sizeof(T));
  block->warps[w]->arrive_and_wait();
  return out;
}

template <class F>
void launch(dim3 grid, dim3 threads, size_t, cudaStream_t, F&& body) {
  for (unsigned b = 0; b < grid.x; ++b) {
    Block blk((int)threads.x);
    block = &blk;
    std::vector<std::thread> pool;
    pool.reserve(threads.x);
    for (unsigned t = 0; t < threads.x; ++t)
      pool.emplace_back([&, t, b] {
        thread_idx = dim3(t);
        block_idx = dim3(b);
        body();
      });
    for (auto& th : pool) th.join();
    block = nullptr;
  }
}

}  // namespace evo_emu

#define threadIdx evo_emu::thread_idx
#define blockIdx evo_emu::block_idx

inline void __syncthreads() { evo_emu::block->sync.arrive_and_wait(); }

template <class T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  return evo_emu::shuffle(v, ((int)evo_emu::thread_idx.x & 31) ^ mask);
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return evo_emu::shuffle(v, src);
}

inline float atomicAdd(float* at, float v) {
  std::lock_guard<std::mutex> hold(evo_emu::block->atomic);
  const float old = *at;
  *at = old + v;
  return old;
}

template <class T>
inline T __ldg(const T* p) { return *p; }

// the card's approximate quotient (a reciprocal of about 1 ulp, times x)
// taken as the exact one; a fused multiply-add rounded once, as on the card
inline float __fdividef(float x, float y) { return x / y; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }

inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch()).count();
}

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

inline cudaError_t cudaGetLastError() { return cudaSuccess; }

