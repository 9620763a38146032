// Reset-aware running sum with a carried base, for Hopper (sm_90a).
//
// Replaces siddhi_tpu/ops/prefix.py running_sum (with its cumsum,
// last_reset_index and cummax, and the TPU-shaped _blocked_scan /
// _hillis_steele they ride). The JAX form is csum_i - csum[last reset] (+ base
// before the first reset); here it is ONE segmented inclusive scan over
// (value, reset) pairs: a reset row contributes (0, restart), any other row
// (contrib, no restart), and (base, no restart) is the carry-in. The output
// is run[n] plus the carry run[n-1] as a device scalar.
//   - n <= 32768: one block of 1024 threads, 32 rows each (read twice: once
//     for the thread aggregate, once to write the outputs).
//   - n > 32768: two passes. Pass 1 reduces each 32768-row tile to its
//     (value, restart) aggregate; pass 2 folds the aggregates of the tiles
//     before it into each tile's carry-in and scans the tile.
// What bounds it on the card: bytes (n values + n flags in, n values out);
// at n = 65536 that is well under a microsecond at 3.35 TB/s, so the launch
// and the serial in-thread loops dominate. Float32 sums run in a different
// order than jnp.cumsum, so results agree to rounding only. Float32 adds are
// XLA's CPU adds (common.cuh xla_add): a subnormal contribution reads as a
// zero of its sign and a partial sum below FLT_MIN flushes, in registers.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 32;
constexpr int kTile = kThreads * kItems;  // keep equal to ops/prefix.py _SCAN_TILE

template <typename T>
struct Seg {
  T v;
  int f;
};

__device__ __forceinline__ float sum_add(float a, float b) { return xla_add(a, b); }
__device__ __forceinline__ int64_t sum_add(int64_t a, int64_t b) { return a + b; }

// a then b: b restarts the sum if it holds a reset
template <typename T>
__device__ __forceinline__ Seg<T> combine(Seg<T> a, Seg<T> b) {
  return Seg<T>{b.f ? b.v : sum_add(a.v, b.v), a.f | b.f};
}

template <typename T>
__device__ __forceinline__ Seg<T> element(const T* contrib, const bool* reset, int i) {
  const bool r = reset[i];
  return Seg<T>{r ? T(0) : sum_add(T(0), contrib[i]), (int)r};
}

// Exclusive scan of one Seg per thread over the block; *total gets the
// block's inclusive total. Every thread of the block must call it.
template <typename T>
__device__ Seg<T> block_exclusive(Seg<T> x, Seg<T>* total) {
  __shared__ T s_v[kThreads / 32];
  __shared__ int s_f[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg<T> incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    Seg<T> y{__shfl_up_sync(kFull, incl.v, d), __shfl_up_sync(kFull, incl.f, d)};
    if (lane >= d) incl = combine(y, incl);
  }
  if (lane == 31) {
    s_v[warp] = incl.v;
    s_f[warp] = incl.f;
  }
  __syncthreads();
  if (warp == 0) {
    Seg<T> w{s_v[lane], s_f[lane]};
    for (int d = 1; d < 32; d <<= 1) {
      Seg<T> y{__shfl_up_sync(kFull, w.v, d), __shfl_up_sync(kFull, w.f, d)};
      if (lane >= d) w = combine(y, w);
    }
    s_v[lane] = w.v;
    s_f[lane] = w.f;
  }
  __syncthreads();
  Seg<T> excl{__shfl_up_sync(kFull, incl.v, 1), __shfl_up_sync(kFull, incl.f, 1)};
  if (lane == 0) excl = Seg<T>{T(0), 0};
  if (warp > 0) excl = combine(Seg<T>{s_v[warp - 1], s_f[warp - 1]}, excl);
  *total = Seg<T>{s_v[kThreads / 32 - 1], s_f[kThreads / 32 - 1]};
  __syncthreads();  // s_v/s_f may be reused by the caller's next call
  return excl;
}

template <typename T>
__device__ Seg<T> thread_aggregate(const T* contrib, const bool* reset, int lo, int hi) {
  Seg<T> a{T(0), 0};
  for (int i = lo; i < hi; ++i) a = combine(a, element(contrib, reset, i));
  return a;
}

template <typename T>
__global__ void tile_aggregate_kernel(const T* contrib, const bool* reset, int n,
                                      T* agg_v, int* agg_f) {
  const int tile0 = blockIdx.x * kTile;
  const int lo = min(tile0 + (int)threadIdx.x * kItems, n);
  const int hi = min(lo + kItems, n);
  Seg<T> total;
  block_exclusive(thread_aggregate(contrib, reset, lo, hi), &total);
  if (threadIdx.x == 0) {
    agg_v[blockIdx.x] = total.v;
    agg_f[blockIdx.x] = total.f;
  }
}

template <typename T>
__global__ void tile_scan_kernel(const T* contrib, const bool* reset, const T* base,
                                 int n, const T* agg_v, const int* agg_f, T* run,
                                 T* carry) {
  __shared__ T c_v;
  __shared__ int c_f;
  if (threadIdx.x == 0) {
    Seg<T> c{*base, 0};
    for (int b = 0; b < (int)blockIdx.x; ++b) c = combine(c, Seg<T>{agg_v[b], agg_f[b]});
    c_v = c.v;
    c_f = c.f;
  }
  __syncthreads();
  const int tile0 = blockIdx.x * kTile;
  const int lo = min(tile0 + (int)threadIdx.x * kItems, n);
  const int hi = min(lo + kItems, n);
  Seg<T> total;
  Seg<T> r = combine(Seg<T>{c_v, c_f},
                     block_exclusive(thread_aggregate(contrib, reset, lo, hi), &total));
  for (int i = lo; i < hi; ++i) {
    r = combine(r, element(contrib, reset, i));
    run[i] = r.v;
    if (i == n - 1) *carry = r.v;
  }
}

template <typename T>
int running_sum(const T* contrib, const bool* reset, const T* base, T* run, T* carry,
                T* agg_v, int* agg_f, int n, cudaStream_t stream) {
  const int tiles = (n + kTile - 1) / kTile;
  if (tiles > 1) {
    tile_aggregate_kernel<T><<<tiles - 1, kThreads, 0, stream>>>(contrib, reset, n,
                                                                 agg_v, agg_f);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  tile_scan_kernel<T><<<tiles, kThreads, 0, stream>>>(contrib, reset, base, n, agg_v,
                                                      agg_f, run, carry);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// agg_v/agg_f: scratch for ceil(n / 32768) tile aggregates
int running_sum_f32(const float* contrib, const bool* reset, const float* base,
                    float* run, float* carry, float* agg_v, int* agg_f, int n,
                    cudaStream_t stream) {
  return running_sum<float>(contrib, reset, base, run, carry, agg_v, agg_f, n, stream);
}

int running_sum_i64(const int64_t* contrib, const bool* reset, const int64_t* base,
                    int64_t* run, int64_t* carry, int64_t* agg_v, int* agg_f, int n,
                    cudaStream_t stream) {
  return running_sum<int64_t>(contrib, reset, base, run, carry, agg_v, agg_f, n,
                              stream);
}

}  // extern "C"
