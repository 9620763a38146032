// Per-row distinct count over the lazy window membership, for Hopper (sm_90a).
//
// Replaces siddhi_tpu/core/aggregators.py DistinctCountAggregator.apply
// (:215-247): per output row p, the number of distinct values among the
// window members alive at p (birth[e] <= p < death[e]), restricted under a
// group-by to members whose key equals the row's. The JAX form builds the
// [rows, K] membership and a [rows, K, K] "earlier equal member" mask; at a
// tumbling-window path's shape (rows ~ 10^5, K ~ 3.5 * 10^4) that is ~10^14
// cells and cannot run. Here the count never looks at a pair of members:
//   1. every element gets a sort record (absent, key, class, value bits,
//      birth, index): absent elements (birth >= death) sort last; a NaN (the
//      null float) equals nothing, so it is class 1 with its index as its
//      value bits; -0.0 is folded onto 0.0; ints, ids and bools are their
//      value. A bitonic sort (one launch per step) orders the element indices.
//   2. each run of equal (key, value) elements, in birth order, is walked by
//      one thread: its alive intervals merge into disjoint blocks, and each
//      block [start, end) files a +1 event at start and a -1 event at end.
//   3. a second bitonic sort orders the events by (key, position); one block
//      takes their inclusive prefix sum.
//   4. row p binary-searches the last event at or before (its key, p): the
//      prefix there is its count (the events of smaller keys sum to zero).
// Counts are integers, so the kernel equals the plain version and JAX
// exactly. Cost: O((K + rows) log^2 K) compares; what bounds it on the card
// is the ~300 sort launches (N = 65536 elements, 131072 events) and their
// gathers, not bytes (K * 16 + rows * 16 bytes: tens of microseconds at
// 3.35 TB/s would be ample).

#include <cstdint>
#include <climits>
#include <cmath>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 32;
constexpr int kScanTile = kScanThreads * kScanItems;

int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

// value bits and class (0 a value, 1 NaN) of one element
__device__ __forceinline__ void canon(float v, int i, long long* vb, int* cls) {
  if (isnan(v)) {
    *cls = 1;
    *vb = i;
  } else {
    *cls = 0;
    v = flush_subnormal(v);  // JAX's `==`: a subnormal equals 0.0
    *vb = v == 0.0f ? 0 : __float_as_int(v);
  }
}
__device__ __forceinline__ void canon(int32_t v, int, long long* vb, int* cls) {
  *cls = 0;
  *vb = v;
}
__device__ __forceinline__ void canon(int64_t v, int, long long* vb, int* cls) {
  *cls = 0;
  *vb = v;
}
__device__ __forceinline__ void canon(uint8_t v, int, long long* vb, int* cls) {
  *cls = 0;
  *vb = v;
}

template <typename T>
__global__ void prep_kernel(const T* vals, const int32_t* birth, const int32_t* death,
                            const int64_t* ekey, int n, int N, long long* e_key,
                            long long* e_vb, int32_t* e_cls, int32_t* e_birth, int32_t* ord) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  long long vb = 0;
  int cls = 2;
  int b = INT_MAX;
  long long key = 0;
  if (i < n) {
    b = birth[i];
    key = ekey != nullptr ? ekey[i] : 0;
    if (b < death[i]) canon(vals[i], i, &vb, &cls);
  }
  e_key[i] = key;
  e_vb[i] = vb;
  e_cls[i] = cls;
  e_birth[i] = b;
  ord[i] = i;
}

struct ElemLess {
  const long long* key;
  const long long* vb;
  const int32_t* cls;
  const int32_t* birth;
  __device__ bool operator()(int a, int b) const {
    const bool xa = cls[a] == 2, xb = cls[b] == 2;
    if (xa != xb) return xb;
    if (key[a] != key[b]) return key[a] < key[b];
    if (cls[a] != cls[b]) return cls[a] < cls[b];
    if (vb[a] != vb[b]) return vb[a] < vb[b];
    if (birth[a] != birth[b]) return birth[a] < birth[b];
    return a < b;
  }
};

struct EventLess {
  const int8_t* absent;
  const long long* key;
  const int32_t* pos;
  __device__ bool operator()(int a, int b) const {
    if (absent[a] != absent[b]) return absent[b];
    if (key[a] != key[b]) return key[a] < key[b];
    if (pos[a] != pos[b]) return pos[a] < pos[b];
    return a < b;
  }
};

template <class Less>
__global__ void bitonic_step(int32_t* ord, int N, int j, int k, Less less) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int l = i ^ j;
  if (l <= i) return;
  const int a = ord[i], b = ord[l];
  const bool up = (i & k) == 0;
  if (up ? less(b, a) : less(a, b)) {
    ord[i] = b;
    ord[l] = a;
  }
}

template <class Less>
int bitonic_sort(int32_t* ord, int N, Less less, cudaStream_t stream) {
  for (int k = 2; k <= N; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      bitonic_step<Less><<<blocks(N), kThreads, 0, stream>>>(ord, N, j, k, less);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

// One thread per run of equal (key, value) elements: merge the run's alive
// intervals (in birth order) into disjoint blocks, each filing a +1 event at
// its start and a -1 event at its end in the slots of its first element.
__global__ void merge_kernel(const int32_t* ord, const long long* e_key, const long long* e_vb,
                             const int32_t* e_cls, const int32_t* e_birth,
                             const int32_t* death, int N, int8_t* ev_absent,
                             long long* ev_key, int32_t* ev_pos, int32_t* ev_delta) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= N) return;
  const int e = ord[s];
  const int c = e_cls[e];
  if (c == 2) return;
  const long long key = e_key[e], vb = e_vb[e];
  if (s > 0 && c == 0) {
    const int q = ord[s - 1];
    if (e_cls[q] == 0 && e_key[q] == key && e_vb[q] == vb) return;  // not the run's head
  }
  auto emit = [&](int at, int start, int end) {
    ev_absent[2 * at] = ev_absent[2 * at + 1] = 0;
    ev_key[2 * at] = ev_key[2 * at + 1] = key;
    ev_pos[2 * at] = start;
    ev_pos[2 * at + 1] = end;
    ev_delta[2 * at] = 1;
    ev_delta[2 * at + 1] = -1;
  };
  int at = s, start = e_birth[e], end = death[e];
  for (int t = s + 1; c == 0 && t < N; ++t) {
    const int f = ord[t];
    if (e_cls[f] != 0 || e_key[f] != key || e_vb[f] != vb) break;
    const int b = e_birth[f], d = death[f];
    if (b > end) {
      emit(at, start, end);
      at = t;
      start = b;
      end = d;
    } else if (d > end) {
      end = d;
    }
  }
  emit(at, start, end);
}

__global__ void iota_kernel(int32_t* ord, int M) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M) ord[i] = i;
}

// pref[s] = inclusive sum of the sorted events' deltas (one block)
__global__ void __launch_bounds__(kScanThreads)
prefix_kernel(const int32_t* ev_ord, const int32_t* ev_delta, int M, int32_t* pref) {
  __shared__ int warp_sums[32];
  int carry = 0;
  for (int base = 0; base < M; base += kScanTile) {
    const int start = base + threadIdx.x * kScanItems;
    int local = 0;
    for (int k = 0; k < kScanItems && start + k < M; ++k) local += ev_delta[ev_ord[start + k]];
    int tile_total;
    int run = carry + block_excl_sum(local, warp_sums, &tile_total);
    for (int k = 0; k < kScanItems && start + k < M; ++k) {
      run += ev_delta[ev_ord[start + k]];
      pref[start + k] = run;
    }
    carry += tile_total;
  }
}

__global__ void count_kernel(const int32_t* ev_ord, const int8_t* ev_absent,
                             const long long* ev_key, const int32_t* ev_pos,
                             const int32_t* pref, const int64_t* rkey, int M, int rows,
                             int64_t* out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= rows) return;
  const long long kr = rkey != nullptr ? rkey[p] : 0;
  int lo = 0, hi = M;  // first sorted event past (kr, p)
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int e = ev_ord[mid];
    const bool at_or_before = !ev_absent[e] &&
                              (ev_key[e] < kr || (ev_key[e] == kr && ev_pos[e] <= p));
    if (at_or_before)
      lo = mid + 1;
    else
      hi = mid;
  }
  out[p] = lo > 0 ? pref[lo - 1] : 0;
}

template <typename T>
int distinct_count(const T* vals, const int32_t* birth, const int32_t* death,
                   const int64_t* ekey, const int64_t* rkey, int64_t* out, int rows, int n,
                   int N, long long* e_key, long long* e_vb, int32_t* e_cls,
                   int32_t* e_birth, int32_t* ord, int8_t* ev_absent, long long* ev_key,
                   int32_t* ev_pos, int32_t* ev_delta, int32_t* ev_ord, int32_t* pref,
                   cudaStream_t stream) {
  const int M = 2 * N;
  cudaError_t err = cudaMemsetAsync(ev_absent, 1, (size_t)M, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(ev_delta, 0, sizeof(int32_t) * (size_t)M, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(ev_key, 0, sizeof(long long) * (size_t)M, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(ev_pos, 0, sizeof(int32_t) * (size_t)M, stream);
  if (err != cudaSuccess) return (int)err;
  prep_kernel<T><<<blocks(N), kThreads, 0, stream>>>(vals, birth, death, ekey, n, N, e_key,
                                                     e_vb, e_cls, e_birth, ord);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int rc = bitonic_sort(ord, N, ElemLess{e_key, e_vb, e_cls, e_birth}, stream);
  if (rc != 0) return rc;
  merge_kernel<<<blocks(N), kThreads, 0, stream>>>(ord, e_key, e_vb, e_cls, e_birth, death, N,
                                                   ev_absent, ev_key, ev_pos, ev_delta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  iota_kernel<<<blocks(M), kThreads, 0, stream>>>(ev_ord, M);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rc = bitonic_sort(ev_ord, M, EventLess{ev_absent, ev_key, ev_pos}, stream);
  if (rc != 0) return rc;
  prefix_kernel<<<1, kScanThreads, 0, stream>>>(ev_ord, ev_delta, M, pref);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    count_kernel<<<blocks(rows), kThreads, 0, stream>>>(ev_ord, ev_absent, ev_key, ev_pos, pref,
                                                        rkey, M, rows, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// N: a power of two >= max(n, 1); scratch: e_key, e_vb [N] int64, e_cls,
// e_birth, ord [N] int32; ev_absent [2N] int8, ev_key [2N] int64, ev_pos,
// ev_delta, ev_ord, pref [2N] int32. ekey/rkey null when ungrouped.
#define DISTINCT_COUNT(SUFFIX, T)                                                          \
  int distinct_count_##SUFFIX(const T* vals, const int32_t* birth, const int32_t* death,   \
                              const int64_t* ekey, const int64_t* rkey, int64_t* out,      \
                              int rows, int n, int N, long long* e_key, long long* e_vb,   \
                              int32_t* e_cls, int32_t* e_birth, int32_t* ord,              \
                              int8_t* ev_absent, long long* ev_key, int32_t* ev_pos,       \
                              int32_t* ev_delta, int32_t* ev_ord, int32_t* pref,           \
                              cudaStream_t stream) {                                       \
    return distinct_count<T>(vals, birth, death, ekey, rkey, out, rows, n, N, e_key, e_vb, \
                             e_cls, e_birth, ord, ev_absent, ev_key, ev_pos, ev_delta,     \
                             ev_ord, pref, stream);                                        \
  }

DISTINCT_COUNT(f32, float)
DISTINCT_COUNT(i32, int32_t)
DISTINCT_COUNT(i64, int64_t)
DISTINCT_COUNT(b8, uint8_t)

}  // extern "C"
