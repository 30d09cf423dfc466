// A stand-in for <cooperative_groups.h> for the CPU emulation of the
// package's kernels (see cuda_runtime.h beside it): the thread-block
// cluster of the calling thread. Its blocks run side by side, their threads
// fibers taking turns, so `sync()` is a barrier over every thread of the
// cluster, and `map_shared_rank` maps a pointer into the calling block's
// dynamic shared memory to the same offset in another block's (the emulated
// kernels keep whatever they share across the cluster there).

#pragma once

#include <cstdio>
#include <cstdlib>

#include "cuda_runtime.h"

namespace cooperative_groups {

struct cluster_group {
  void sync() const { evo_emu::block->cluster->sync.arrive_and_wait(); }
  unsigned block_rank() const { return evo_emu::block->rank; }
  unsigned num_blocks() const { return (unsigned)evo_emu::block->cluster->blocks.size(); }
  template <class T>
  T* map_shared_rank(T* p, unsigned rank) const {
    char* base = reinterpret_cast<char*>(evo_emu::block->dynamic.data());
    const std::ptrdiff_t off = reinterpret_cast<char*>(p) - base;
    if (off < 0 || (size_t)off >= evo_emu::block->dynamic.size() * sizeof(float)) {
      std::fprintf(stderr, "map_shared_rank: not a pointer into dynamic shared memory\n");
      std::abort();
    }
    char* other = reinterpret_cast<char*>(evo_emu::block->cluster->blocks[rank]->dynamic.data());
    return reinterpret_cast<T*>(other + off);
  }
};

inline cluster_group this_cluster() { return {}; }

}  // namespace cooperative_groups
