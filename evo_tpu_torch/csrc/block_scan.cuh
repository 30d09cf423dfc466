// An exclusive prefix sum over a block, shared by `frame_policy.cu` and
// `route_events.cu`: each warp scans by shuffles, warp 0 scans the warps'
// totals. Include it after <cuda_runtime.h>.

#pragma once

// The exclusive prefix sum of v over the block's kWarps warps in thread
// order; `total` gets the sum. `warp_int` is shared memory of kWarps + 1
// ints. Every thread must call it; it ends with a barrier, so the next call
// may reuse `warp_int`.
template <int kWarps>
__device__ int block_scan(int v, int* warp_int, int& total) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int got = __shfl_sync(full, inc, (lane - off) & 31);
    if (lane >= off) inc += got;
  }
  if (lane == 31) warp_int[warp] = inc;
  __syncthreads();
  if (warp == 0) {  // the warps' totals, scanned by warp 0's lanes
    const int s = lane < kWarps ? warp_int[lane] : 0;
    int x = s;
    for (int off = 1; off < 32; off <<= 1) {
      const int got = __shfl_sync(full, x, (lane - off) & 31);
      if (lane >= off) x += got;
    }
    if (lane < kWarps) warp_int[lane] = x - s;
    if (lane == 31) warp_int[kWarps] = x;
  }
  __syncthreads();
  total = warp_int[kWarps];
  const int out = warp_int[warp] + inc - v;
  __syncthreads();
  return out;
}
