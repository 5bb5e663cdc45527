// Shared helpers for the pgrtk_tpu_torch kernels.
//
// Every C entry point launches on the stream it is given, allocates
// nothing, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.  None synchronises: K12 (adj.cu) plans its digit
// passes on the card.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pgrtk {

// gridDim.y limit.  Kernels that put rows on the y axis take a first-row
// argument, and their entry points launch once per tile of this many rows.
constexpr int kMaxGridY = 65535;

// Exclusive prefix sum of one int per thread over the whole block.
// blockDim.x must be a multiple of 32 and at most 1024; every thread of
// the block must call it.  `warp_sums` is 32 ints of shared memory.
// *total receives the block-wide sum.  Ends with a barrier, so the
// shared buffer can be reused by the next call.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total,
                                                    int* warp_sums) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(full, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(full, s, d);
      if (lane >= d) s += y;
    }
    warp_sums[lane] = s;  // inclusive sum over warps 0..lane
  }
  __syncthreads();
  const int incl = x + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[n_warps - 1];
  __syncthreads();
  return incl - v;
}

// Allow `kernel` `bytes` of dynamic shared memory on the current device,
// once per device and size (the call costs host time on every launch
// otherwise).  Returns the error of the first call.  The record is kept
// by the kernel's type; kernels of one type (a template's instances) each
// take their own kTag.
template <int kTag = 0, typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  static int done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = bytes;
  return err;
}

// The current device's SM count, read once per device.
inline int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < 64 && sms[dev]) return sms[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  n = n > 0 ? n : 132;
  if (dev < 64) sms[dev] = n;
  return n;
}

}  // namespace pgrtk
