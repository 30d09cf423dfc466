// A stand-in for <cuda_pipeline.h> for the CPU emulation of the package's
// kernels (see cuda_runtime.h beside it): an asynchronous copy is a copy
// made at once, so a commit and a wait have nothing left to do.

#pragma once

#include <cstddef>
#include <cstring>

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t bytes,
                                    size_t zero_fill = 0) {
  std::memcpy(dst, src, bytes - zero_fill);
  if (zero_fill) std::memset((char*)dst + bytes - zero_fill, 0, zero_fill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
