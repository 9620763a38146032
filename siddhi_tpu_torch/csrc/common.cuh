// Device helpers shared by the kernels of this directory. Each .cu includes
// this header and is still built into a library of its own.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// Exclusive block-wide sum of one int per thread: returns the sum over the
// threads before this one and sets *total to the block's sum. Every thread
// of the block calls it; blockDim.x is a multiple of 32, and ws is a
// __shared__ int[32].
__device__ __forceinline__ int block_excl_sum(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = lane < warps ? ws[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += y;
    }
    if (lane < warps) ws[lane] = x;
  }
  __syncthreads();
  const int excl = incl - v + (warp > 0 ? ws[warp - 1] : 0);
  *total = ws[warps - 1];
  __syncthreads();
  return excl;
}

// out[k] = i < 0 ? null : i < W ? a[i] : b ? b[i - W] : null, with i = idx[k]:
// one lane gathered from two sources laid end to end (b may be null).
template <typename T>
__global__ void gather2_kernel(const T* a, const T* b, const int32_t* idx, T null, T* out,
                               int n, int W) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int i = idx[k];
  out[k] = i < 0 ? null : i < W ? a[i] : b != nullptr ? b[i - W] : null;
}

template <typename T>
int gather2(const void* a, const void* b, const int32_t* idx, long long null_bits, void* out,
            int n, int W, cudaStream_t stream) {
  constexpr int threads = 256;
  gather2_kernel<T><<<(n + threads - 1) / threads, threads, 0, stream>>>(
      (const T*)a, (const T*)b, idx, (T)null_bits, (T*)out, n, W);
  return (int)cudaGetLastError();
}

}  // namespace
