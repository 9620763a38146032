// Device helpers shared by the kernels of this directory. Each .cu includes
// this header and is still built into a library of its own.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// A float32 as XLA compares it: a subnormal is a zero of its own sign (the
// JAX package's comparisons, sorts and searches flush them); NaN and every
// other value as it is. siddhi_tpu_torch/core/types.py flush_subnormal.
__device__ __forceinline__ bool is_subnormal_or_zero(unsigned int u) {
  return (u & 0x7f800000u) == 0u;
}
__device__ __forceinline__ float flush_subnormal(float f) {
  const unsigned int u = __float_as_uint(f);
  return is_subnormal_or_zero(u) ? __uint_as_float(u & 0x80000000u) : f;
}

// Float32 arithmetic as XLA's CPU code computes it for the JAX package
// (siddhi_tpu_torch/core/types.py float_arith): + - * / read a subnormal
// operand as a zero of its sign (DAZ) and give a zero of its sign where the
// result, rounded to 24 bits with an unbounded exponent, lies below FLT_MIN
// (FTZ, tininess after rounding). A sum below FLT_MIN is exact, so its flush
// needs no more; a product or quotient that rounds to +-FLT_MIN is checked
// in float64 against FLT_MIN * (1 - 2^-25). In registers, no memory traffic.
constexpr float kFltMin = 0x1p-126f;
constexpr double kFtzBelow = 0x1.ffffffp-127;
__device__ __forceinline__ float xla_add(float a, float b) {
  return flush_subnormal(__fadd_rn(flush_subnormal(a), flush_subnormal(b)));
}
__device__ __forceinline__ float xla_sub(float a, float b) {
  return flush_subnormal(__fsub_rn(flush_subnormal(a), flush_subnormal(b)));
}
__device__ __forceinline__ float ftz_checked(float r, double p) {
  return fabsf(r) <= kFltMin && fabs(p) < kFtzBelow
             ? __uint_as_float(__float_as_uint(r) & 0x80000000u)
             : r;
}
__device__ __forceinline__ float xla_mul(float a, float b) {
  a = flush_subnormal(a);
  b = flush_subnormal(b);
  return ftz_checked(__fmul_rn(a, b), (double)a * (double)b);
}
__device__ __forceinline__ float xla_div(float a, float b) {
  a = flush_subnormal(a);
  b = flush_subnormal(b);
  return ftz_checked(__fdiv_rn(a, b), __ddiv_rn((double)a, (double)b));
}
// fmodf is a library call in XLA's CPU code: only a subnormal divisor reads
// as zero
__device__ __forceinline__ float xla_mod(float a, float b) { return fmodf(a, flush_subnormal(b)); }

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

// Inclusive block-wide minimum of one int per thread (same contract as
// block_excl_sum); *total gets the block's minimum.
__device__ __forceinline__ int block_incl_min(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = min(incl, y);
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = lane < warps ? ws[lane] : 0x7fffffff;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = min(x, y);
    }
    if (lane < warps) ws[lane] = x;
  }
  __syncthreads();
  const int out = warp > 0 ? min(incl, ws[warp - 1]) : incl;
  *total = ws[warps - 1];
  __syncthreads();
  return out;
}

// Token-table lanes rebuilt through an index map (the pattern kernels):
// element i of lane l, in row r = i / width, takes m = idx[i] (per_elem) or
// idx[r], and becomes src[m] when m >= 0, old[i] when m == -1, and the
// lane's null bit pattern otherwise. Up to kMaxGatherLanes lanes a launch.
constexpr int kMaxGatherLanes = 16;

struct GatherLanes {
  const void* old[kMaxGatherLanes];
  const void* src[kMaxGatherLanes];
  void* out[kMaxGatherLanes];
  const int32_t* idx[kMaxGatherLanes];
  long long null_bits[kMaxGatherLanes];
  int size[kMaxGatherLanes];
  int width[kMaxGatherLanes];
  int per_elem[kMaxGatherLanes];
  int n;
};

template <typename T>
__device__ __forceinline__ void gather_lane_elem(const GatherLanes& L, int l, long long i, int m) {
  const T v = m >= 0 ? ((const T*)L.src[l])[m]
              : m == -1 ? ((const T*)L.old[l])[i] : (T)L.null_bits[l];
  ((T*)L.out[l])[i] = v;
}

__global__ void gather_lanes_kernel(GatherLanes L, int rows) {
  const int l = blockIdx.y;
  const int w = L.width[l];
  const long long n = (long long)rows * w;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int m = L.per_elem[l] ? L.idx[l][i] : L.idx[l][i / w];
    switch (L.size[l]) {
      case 1: gather_lane_elem<uint8_t>(L, l, i, m); break;
      case 4: gather_lane_elem<uint32_t>(L, l, i, m); break;
      default: gather_lane_elem<unsigned long long>(L, l, i, m); break;
    }
  }
}

// Launch gather_lanes_kernel over `n` lanes of `rows` rows, given as host
// arrays, kMaxGatherLanes at a time.
inline int gather_lanes(int n, const void* const* old, const void* const* src, void* const* out,
                        const int32_t* const* idx, const long long* null_bits, const int* size,
                        const int* width, const int* per_elem, int rows, cudaStream_t stream) {
  for (int base = 0; base < n; base += kMaxGatherLanes) {
    GatherLanes L;
    L.n = n - base < kMaxGatherLanes ? n - base : kMaxGatherLanes;
    int wmax = 1;
    for (int k = 0; k < L.n; ++k) {
      L.old[k] = old[base + k];
      L.src[k] = src[base + k];
      L.out[k] = out[base + k];
      L.idx[k] = idx[base + k];
      L.null_bits[k] = null_bits[base + k];
      L.size[k] = size[base + k];
      L.width[k] = width[base + k];
      L.per_elem[k] = per_elem[base + k];
      wmax = width[base + k] > wmax ? width[base + k] : wmax;
    }
    const long long elems = (long long)rows * wmax;
    int blocks = (int)((elems + 255) / 256);
    blocks = blocks < 1 ? 1 : blocks > 1024 ? 1024 : blocks;
    gather_lanes_kernel<<<dim3(blocks, L.n), 256, 0, stream>>>(L, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace
