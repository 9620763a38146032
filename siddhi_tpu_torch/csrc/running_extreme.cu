// Running min/max with reset barriers and a carry, flat (K18) and per group
// (K19), for Hopper (sm_90a).
//
// K18 replaces siddhi_tpu/ops/prefix.py running_extreme (:71): inactive rows
// masked to the identity, a segmented associative scan over (value, reset)
// pairs (_blocked_scan :122, combine :89-93), and op(scan, base) before the
// first reset. Here, as csrc/running_sum.cu does for the sum, it is ONE
// segmented inclusive scan: a row is (value if active else identity, restart
// if reset), and (base, no restart) is the carry-in.
//   - n <= 32768: one block of 1024 threads, 32 rows each;
//   - n > 32768: pass 1 reduces each 32768-row tile to its (value, restart)
//     aggregate; pass 2 folds the earlier tiles' aggregates into each tile's
//     carry-in and scans the tile.
// K19 replaces siddhi_tpu/ops/group.py keyed_running_extreme (:241) with
// ops/prefix.py segmented_cum_extreme (:198) over the lax.sort-ed view and
// the final-segment writers of the [G] carry: it is csrc/keyed_running_sum.cu
// (K8) with min/max for the sum and the identity for zero. Rows stay in
// arrival order and a group is named by its segment id `first` (from
// csrc/group_assign.cu): a tile pass reduces each 512-row tile's earlier rows
// of the same segment and files each segment's tile aggregate in the tile's
// hash table; a row pass folds in the aggregates its segment filed in earlier
// tiles, then its group's carry when no reset of the given lane precedes it
// (its first and last RESET rows come from one small pass); the last row of
// each final-era segment writes its slot's new carry (the latest such
// segment of a slot, as the plain version's scatter keeps it).
// NaN: jnp.minimum/maximum propagate it (a null float is NaN), while CUDA's
// fminf/fmaxf drop it, so the comparisons here are written out and any NaN
// operand wins; of zeros of both signs the minimum is -0.0 and the maximum
// 0.0. Min and max are then exact in any order, so both kernels equal their
// plain versions bit for bit (up to which NaN is kept). A float32
// subnormal value reads as a zero of its sign, as XLA's CPU code reads it
// (common.cuh flush_subnormal, in registers).
// What bounds them on the card: bytes (n values + 2n flags in, n values out;
// K19 also the ids, slots and the [G] carry): well under a microsecond at
// 3.35 TB/s at n = 32768; the launches, the serial in-thread loops (K18) and
// the tile pass's O(tile^2) compares (K19) dominate.

#include <cstdint>
#include <climits>
#include <cmath>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 32;
constexpr int kTile = kThreads * kItems;  // keep equal to ops/prefix.py _SCAN_TILE
constexpr int kKeyTile = 512;  // keep equal to ops/group.py _SUM_TILE
constexpr int kHash = 1024;    // keep equal to ops/group.py _SUM_HASH
constexpr int kRowThreads = 256;

template <typename T> struct Lim;
template <> struct Lim<float> {
  __device__ static float hi() { return INFINITY; }
  __device__ static float lo() { return -INFINITY; }
  __device__ static bool nan(float v) { return isnan(v); }
  __device__ static float read(float v) { return flush_subnormal(v); }
  __device__ static bool neg(float v) { return signbit(v); }
};
template <> struct Lim<int32_t> {
  __device__ static int32_t hi() { return INT_MAX; }
  __device__ static int32_t lo() { return INT_MIN; }
  __device__ static bool nan(int32_t) { return false; }
  __device__ static int32_t read(int32_t v) { return v; }
  __device__ static bool neg(int32_t v) { return v < 0; }
};
template <> struct Lim<int64_t> {
  __device__ static int64_t hi() { return LLONG_MAX; }
  __device__ static int64_t lo() { return LLONG_MIN; }
  __device__ static bool nan(int64_t) { return false; }
  __device__ static int64_t read(int64_t v) { return v; }
  __device__ static bool neg(int64_t v) { return v < 0; }
};

// min or max with NaN propagation; of zeros of both signs the minimum is
// -0.0 and the maximum 0.0, in any order (XLA's jnp.minimum/maximum)
template <typename T>
__device__ __forceinline__ T ext(T a, T b, bool is_min) {
  if (Lim<T>::nan(a)) return a;
  if (Lim<T>::nan(b)) return b;
  if (a == b) return Lim<T>::neg(a) == is_min ? a : b;
  return is_min ? (b < a ? b : a) : (b > a ? b : a);
}

template <typename T>
__device__ __forceinline__ T identity(bool is_min) {
  return is_min ? Lim<T>::hi() : Lim<T>::lo();
}

// ---------------------------------------------------------------------------
// K18: flat running extreme
// ---------------------------------------------------------------------------

template <typename T>
struct Seg {
  T v;
  int f;
};

template <typename T>
__device__ __forceinline__ Seg<T> combine(Seg<T> a, Seg<T> b, bool is_min) {
  return Seg<T>{b.f ? b.v : ext(a.v, b.v, is_min), a.f | b.f};
}

template <typename T>
__device__ __forceinline__ Seg<T> element(const T* values, const bool* active,
                                          const bool* reset, int i, bool is_min) {
  return Seg<T>{active[i] ? Lim<T>::read(values[i]) : identity<T>(is_min), (int)reset[i]};
}

// Exclusive scan of one Seg per thread over the block (identity before the
// first thread); *total gets the block's inclusive total.
template <typename T>
__device__ Seg<T> block_exclusive(Seg<T> x, Seg<T>* total, bool is_min) {
  __shared__ T s_v[kThreads / 32];
  __shared__ int s_f[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg<T> incl = x;
  for (int d = 1; d < 32; d <<= 1) {
    Seg<T> y{__shfl_up_sync(kFull, incl.v, d), __shfl_up_sync(kFull, incl.f, d)};
    if (lane >= d) incl = combine(y, incl, is_min);
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
      if (lane >= d) w = combine(y, w, is_min);
    }
    s_v[lane] = w.v;
    s_f[lane] = w.f;
  }
  __syncthreads();
  Seg<T> excl{__shfl_up_sync(kFull, incl.v, 1), __shfl_up_sync(kFull, incl.f, 1)};
  if (lane == 0) excl = Seg<T>{identity<T>(is_min), 0};
  if (warp > 0) excl = combine(Seg<T>{s_v[warp - 1], s_f[warp - 1]}, excl, is_min);
  *total = Seg<T>{s_v[kThreads / 32 - 1], s_f[kThreads / 32 - 1]};
  __syncthreads();
  return excl;
}

template <typename T>
__device__ Seg<T> thread_aggregate(const T* values, const bool* active, const bool* reset,
                                   int lo, int hi, bool is_min) {
  Seg<T> a{identity<T>(is_min), 0};
  for (int i = lo; i < hi; ++i) a = combine(a, element(values, active, reset, i, is_min), is_min);
  return a;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_aggregate_kernel(const T* values, const bool* active, const bool* reset, int n,
                      int is_min, T* agg_v, int* agg_f) {
  const int lo = min((int)blockIdx.x * kTile + (int)threadIdx.x * kItems, n);
  const int hi = min(lo + kItems, n);
  Seg<T> total;
  block_exclusive(thread_aggregate(values, active, reset, lo, hi, is_min != 0), &total,
                  is_min != 0);
  if (threadIdx.x == 0) {
    agg_v[blockIdx.x] = total.v;
    agg_f[blockIdx.x] = total.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tile_scan_kernel(const T* values, const bool* active, const bool* reset, const T* base,
                 int n, int is_min_, const T* agg_v, const int* agg_f, T* run, T* carry) {
  const bool is_min = is_min_ != 0;
  __shared__ T c_v;
  __shared__ int c_f;
  if (threadIdx.x == 0) {
    Seg<T> c{Lim<T>::read(*base), 0};
    for (int b = 0; b < (int)blockIdx.x; ++b) c = combine(c, Seg<T>{agg_v[b], agg_f[b]}, is_min);
    c_v = c.v;
    c_f = c.f;
  }
  __syncthreads();
  const int lo = min((int)blockIdx.x * kTile + (int)threadIdx.x * kItems, n);
  const int hi = min(lo + kItems, n);
  Seg<T> total;
  Seg<T> r = combine(Seg<T>{c_v, c_f},
                     block_exclusive(thread_aggregate(values, active, reset, lo, hi, is_min),
                                     &total, is_min),
                     is_min);
  for (int i = lo; i < hi; ++i) {
    r = combine(r, element(values, active, reset, i, is_min), is_min);
    run[i] = r.v;
    if (i == n - 1) *carry = r.v;
  }
}

template <typename T>
int running_extreme(const T* values, const bool* active, const bool* reset, const T* base,
                    T* run, T* carry, T* agg_v, int* agg_f, int n, int is_min,
                    cudaStream_t stream) {
  const int tiles = (n + kTile - 1) / kTile;
  if (tiles > 1) {
    tile_aggregate_kernel<T><<<tiles - 1, kThreads, 0, stream>>>(values, active, reset, n,
                                                                 is_min, agg_v, agg_f);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  tile_scan_kernel<T><<<tiles, kThreads, 0, stream>>>(values, active, reset, base, n, is_min,
                                                      agg_v, agg_f, run, carry);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K19: keyed running extreme over (era, key) segments, with the [G] carry
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned hash32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kKeyTile)
key_tile_kernel(const T* values, const bool* active, const int32_t* first,
                const int32_t* bounds, const T* carry, int rows, int G, int is_min_, T* part,
                int32_t* seg_last, int32_t* tab_key, T* tab_val, T* new_carry) {
  const bool is_min = is_min_ != 0;
  __shared__ int32_t s_first[kKeyTile];
  __shared__ T s_val[kKeyTile];
  const int t = threadIdx.x;
  const int base = blockIdx.x * kKeyTile;
  const int r = base + t;
  const int len = rows - base < kKeyTile ? rows - base : kKeyTile;
  const T ident = identity<T>(is_min);
  if (t < len) {
    s_first[t] = first[r];
    s_val[t] = active[r] ? Lim<T>::read(values[r]) : ident;
  }
  __syncthreads();
  // the new carry's base: the identity when the batch holds a reset
  const bool any_reset = bounds[1] >= 0;
  for (int j = blockIdx.x * kKeyTile + t; j < G; j += gridDim.x * kKeyTile)
    new_carry[j] = any_reset ? ident : carry[j];
  if (t >= len) return;
  const int mine = s_first[t];
  T acc = ident;
  bool later = false;
  for (int j = 0; j < len; ++j) {
    if (s_first[j] == mine) {
      if (j <= t)
        acc = ext(acc, s_val[j], is_min);
      else
        later = true;
    }
  }
  part[r] = acc;
  atomicMax(&seg_last[mine], r);
  if (!later) {
    int32_t* keys = tab_key + (size_t)blockIdx.x * kHash;
    unsigned h = hash32((unsigned)mine) & (kHash - 1);
    while (atomicCAS(&keys[h], -1, mine) != -1) h = (h + 1) & (kHash - 1);
    tab_val[(size_t)blockIdx.x * kHash + h] = acc;
  }
}

template <typename T>
__global__ void key_row_kernel(const int32_t* first, const int32_t* bounds, const T* carry,
                               const int32_t* slot, T* part, const int32_t* seg_last,
                               const int32_t* tab_key, const T* tab_val, int rows, int G,
                               int is_min_, T* run, int32_t* slot_win) {
  const bool is_min = is_min_ != 0;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T ident = identity<T>(is_min);
  const int f = first[r];
  T cross = ident;
  for (int tt = f / kKeyTile; tt < r / kKeyTile; ++tt) {
    const int32_t* keys = tab_key + (size_t)tt * kHash;
    unsigned h = hash32((unsigned)f) & (kHash - 1);
    for (;;) {
      const int k = keys[h];
      if (k == f) {
        cross = ext(cross, tab_val[(size_t)tt * kHash + h], is_min);
        break;
      }
      if (k < 0) break;
      h = (h + 1) & (kHash - 1);
    }
  }
  const T seg = ext(cross, part[r], is_min);
  part[r] = seg;  // the segment's running value, read back by the writer pass
  const int s = slot[r];
  const bool live = s >= 0 && s < G;
  run[r] = ext(seg, r < bounds[0] && live ? Lim<T>::read(carry[s]) : ident, is_min);
  if (live && r > bounds[1] && seg_last[f] == r) atomicMax(&slot_win[s], f);
}

// The carry write: a slot's new carry comes from the end of its last
// final-era segment. With the reset lane zeroed (the forever forms) while
// the segments still split at RESET rows, one slot can end several
// segments; the plain version's scatter keeps the last of them in segment
// order, so the latest segment head wins here too.
template <typename T>
__global__ void key_write_kernel(const int32_t* first, const int32_t* bounds, const T* carry,
                                 const int32_t* slot, const T* part, const int32_t* seg_last,
                                 const int32_t* slot_win, int rows, int G, int is_min_,
                                 T* new_carry) {
  const bool is_min = is_min_ != 0;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int f = first[r], s = slot[r];
  if (s < 0 || s >= G || r <= bounds[1] || seg_last[f] != r || slot_win[s] != f) return;
  new_carry[s] = ext(bounds[1] >= 0 ? identity<T>(is_min) : Lim<T>::read(carry[s]), part[r],
                     is_min);
}

// bounds = [first, last] RESET row of `reset` (rows and -1 when none): the
// reset lane the caller passes, which for the forever forms is all false
// while the segments still split at the flow's resets. One block.
__global__ void __launch_bounds__(kThreads)
reset_bounds_kernel(const bool* reset, int rows, int32_t* bounds) {
  __shared__ int lo, hi;
  if (threadIdx.x == 0) {
    lo = rows;
    hi = -1;
  }
  __syncthreads();
  int my_lo = rows, my_hi = -1;
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    if (reset[r]) {
      my_lo = min(my_lo, r);
      my_hi = max(my_hi, r);
    }
  }
  if (my_hi >= 0) {
    atomicMin(&lo, my_lo);
    atomicMax(&hi, my_hi);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bounds[0] = lo;
    bounds[1] = hi;
  }
}

template <typename T>
int keyed_running_extreme(const T* values, const bool* active, const int32_t* first,
                          const bool* reset, const T* carry, const int32_t* slot, int rows,
                          int G, int is_min, T* run, T* new_carry, T* part, int32_t* seg_last,
                          int32_t* tab_key, T* tab_val, int32_t* slot_win, int32_t* bounds,
                          cudaStream_t stream) {
  const int tiles = (rows + kKeyTile - 1) / kKeyTile;
  reset_bounds_kernel<<<1, kThreads, 0, stream>>>(reset, rows, bounds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(seg_last, 0xff, sizeof(int32_t) * (size_t)rows, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(tab_key, 0xff, sizeof(int32_t) * (size_t)tiles * kHash, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(slot_win, 0xff, sizeof(int32_t) * (size_t)G, stream);
  if (err != cudaSuccess) return (int)err;
  key_tile_kernel<T><<<tiles, kKeyTile, 0, stream>>>(values, active, first, bounds, carry, rows,
                                                     G, is_min, part, seg_last, tab_key,
                                                     tab_val, new_carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int row_blocks = (rows + kRowThreads - 1) / kRowThreads;
  key_row_kernel<T><<<row_blocks, kRowThreads, 0, stream>>>(
      first, bounds, carry, slot, part, seg_last, tab_key, tab_val, rows, G, is_min, run,
      slot_win);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  key_write_kernel<T><<<row_blocks, kRowThreads, 0, stream>>>(
      first, bounds, carry, slot, part, seg_last, slot_win, rows, G, is_min, new_carry);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// agg_v/agg_f: scratch for ceil(n / 32768) tile aggregates
#define RUNNING_EXTREME(SUFFIX, T)                                                        \
  int running_extreme_##SUFFIX(const T* values, const bool* active, const bool* reset,    \
                               const T* base, T* run, T* carry, T* agg_v, int* agg_f,     \
                               int n, int is_min, cudaStream_t stream) {                 \
    return running_extreme<T>(values, active, reset, base, run, carry, agg_v, agg_f, n,  \
                              is_min, stream);                                           \
  }                                                                                       \
  int keyed_running_extreme_##SUFFIX(const T* values, const bool* active,                 \
                                     const int32_t* first, const bool* reset,             \
                                     const T* carry, const int32_t* slot, int rows,       \
                                     int G, int is_min, T* run, T* new_carry, T* part,    \
                                     int32_t* seg_last, int32_t* tab_key, T* tab_val,     \
                                     int32_t* slot_win, int32_t* bounds,                  \
                                     cudaStream_t stream) {                               \
    return keyed_running_extreme<T>(values, active, first, reset, carry, slot, rows, G,   \
                                    is_min, run, new_carry, part, seg_last, tab_key,      \
                                    tab_val, slot_win, bounds, stream);                   \
  }

RUNNING_EXTREME(f32, float)
RUNNING_EXTREME(i32, int32_t)
RUNNING_EXTREME(i64, int64_t)

}  // extern "C"
