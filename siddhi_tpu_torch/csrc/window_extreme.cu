// Windowed min/max over the lazy membership lanes, for Hopper (sm_90a).
//
// Replaces the windowed branch of siddhi_tpu/core/aggregators.py
// ExtremeAggregator.apply together with the membership matrix it reduces
// (siddhi_tpu/core/windows.py:401-418, `member[p, e] = present[e] &
// birth[e] <= p < death[e]`). The JAX form materialises [rows, elements]
// and reduces it; here the matrix is never built: output row p reduces
// vals[e] over the elements with birth[e] <= p < death[e] (absent elements
// carry death = -1), starting from the identity (+inf/-inf, or the integer
// extreme as ops/prefix.py extreme_identity), and an empty window (result
// == identity) becomes the null sentinel. NaN propagates as in jnp.min/max;
// of zeros of both signs the minimum is -0.0 and the maximum 0.0, in any
// order; a float32 subnormal value reads as a zero of its sign, as XLA's
// CPU code reads it (common.cuh flush_subnormal, when the tile is loaded).
// The loop compares integer order keys made once an element (Limits::key),
// one compare a (row, element) pair.
// Design: one thread per output row, 256 rows per block; the element lanes
// stream through shared memory in tiles of 1024, every thread of a warp
// reading the same element (a broadcast).
// The keyed entry points are the grouped branch (:196-199,
// `member & (key_of(member_env)[e] == group.key[p])`): an int64 key lane per
// element and per row, compared in the same loop.
// Cost: O(rows * elements) = O(2B * (W + B)) membership tests, about 2.1e9
// at B = 32768, W = 50 — bound by those tests, not by bytes (the lanes are
// well under 1 MB). Under a length window only about W elements are alive
// at any row and alive elements form a narrow band in birth order, so an
// O(B * W) form that visits only the band is the way to make it fast.

#include <cstdint>
#include <climits>
#include <cmath>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileElems = 1024;

template <typename T> struct Limits;
// key(v): an integer in v's order, the min and max compare keys. A float's
// key is its total order (-0.0 below 0.0, so a zero of each sign gives -0.0
// for min and 0.0 for max in any order); a NaN's is below every number for
// min and above for max, so the first NaN met wins and sticks.
template <> struct Limits<float> {
  using Key = int;
  __device__ static float hi() { return INFINITY; }
  __device__ static float lo() { return -INFINITY; }
  __device__ static float read(float v) { return flush_subnormal(v); }
  __device__ static int key(float v, bool is_min) {
    if (isnan(v)) return is_min ? INT_MIN : INT_MAX;
    const int u = __float_as_int(v);
    return u >= 0 ? u : u ^ 0x7fffffff;
  }
  __device__ static float from_bits(long long b) { return __int_as_float((int)b); }
};
template <> struct Limits<int32_t> {
  using Key = int32_t;
  __device__ static int32_t hi() { return INT_MAX; }
  __device__ static int32_t lo() { return INT_MIN; }
  __device__ static int32_t read(int32_t v) { return v; }
  __device__ static int32_t key(int32_t v, bool) { return v; }
  __device__ static int32_t from_bits(long long b) { return (int32_t)b; }
};
template <> struct Limits<int64_t> {
  using Key = int64_t;
  __device__ static int64_t hi() { return LLONG_MAX; }
  __device__ static int64_t lo() { return LLONG_MIN; }
  __device__ static int64_t read(int64_t v) { return v; }
  __device__ static int64_t key(int64_t v, bool) { return v; }
  __device__ static int64_t from_bits(long long b) { return (int64_t)b; }
};

// Keyed: an element counts toward row p only if ekey[e] == rkey[p] (the
// grouped form); otherwise ekey/rkey are not read.
template <typename T, bool Keyed>
__global__ void window_extreme_kernel(const T* vals, const int32_t* birth,
                                      const int32_t* death, const int64_t* ekey,
                                      const int64_t* rkey, T* out, int n_rows,
                                      int n_elems, int is_min, long long null_bits) {
  using Key = typename Limits<T>::Key;
  __shared__ T s_val[kTileElems];
  __shared__ Key s_key[kTileElems];
  __shared__ int32_t s_birth[kTileElems];
  __shared__ int32_t s_death[kTileElems];
  __shared__ int64_t s_ekey[Keyed ? kTileElems : 1];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const T ident = is_min ? Limits<T>::hi() : Limits<T>::lo();
  const int64_t mine = Keyed && p < n_rows ? rkey[p] : 0;
  T red = ident;
  Key rk = Limits<T>::key(ident, is_min);
  for (int e0 = 0; e0 < n_elems; e0 += kTileElems) {
    const int m = min(kTileElems, n_elems - e0);
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      const T v = Limits<T>::read(vals[e0 + k]);
      s_val[k] = v;
      s_key[k] = Limits<T>::key(v, is_min);
      s_birth[k] = birth[e0 + k];
      s_death[k] = death[e0 + k];
      if (Keyed) s_ekey[k] = ekey[e0 + k];
    }
    __syncthreads();
    if (p < n_rows) {
      for (int k = 0; k < m; ++k) {
        if (s_birth[k] <= p && p < s_death[k] && (!Keyed || s_ekey[k] == mine)) {
          const Key kv = s_key[k];
          if (is_min ? kv < rk : kv > rk) {
            rk = kv;
            red = s_val[k];
          }
        }
      }
    }
    __syncthreads();
  }
  if (p < n_rows) out[p] = red == ident ? Limits<T>::from_bits(null_bits) : red;
}

template <typename T, bool Keyed>
int window_extreme(const T* vals, const int32_t* birth, const int32_t* death,
                   const int64_t* ekey, const int64_t* rkey, T* out, int n_rows, int n_elems,
                   int is_min, long long null_bits, cudaStream_t stream) {
  window_extreme_kernel<T, Keyed>
      <<<(n_rows + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
          vals, birth, death, ekey, rkey, out, n_rows, n_elems, is_min, null_bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// null_bits: the null sentinel's bit pattern in the low bits (float: as int32);
// the _keyed entry points take [K] element keys and [n_rows] row keys (int64)
#define WINDOW_EXTREME(SUFFIX, T)                                                         \
  int window_extreme_##SUFFIX(const T* vals, const int32_t* birth, const int32_t* death,  \
                              T* out, int n_rows, int n_elems, int is_min,                \
                              long long null_bits, cudaStream_t stream) {                 \
    return window_extreme<T, false>(vals, birth, death, nullptr, nullptr, out, n_rows,    \
                                    n_elems, is_min, null_bits, stream);                  \
  }                                                                                       \
  int window_extreme_keyed_##SUFFIX(const T* vals, const int32_t* birth,                  \
                                    const int32_t* death, const int64_t* ekey,            \
                                    const int64_t* rkey, T* out, int n_rows, int n_elems, \
                                    int is_min, long long null_bits,                      \
                                    cudaStream_t stream) {                                \
    return window_extreme<T, true>(vals, birth, death, ekey, rkey, out, n_rows, n_elems,  \
                                   is_min, null_bits, stream);                            \
  }

WINDOW_EXTREME(f32, float)
WINDOW_EXTREME(i32, int32_t)
WINDOW_EXTREME(i64, int64_t)

}  // extern "C"
