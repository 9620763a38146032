// Keyed running sum over a batch's (era, key) groups, with the [G] carry,
// for Hopper (sm_90a).
//
// Replaces siddhi_tpu/ops/group.py keyed_running_sum (:205-238) with
// ops/prefix.py segmented_cumsum (:193, the blocked Hillis-Steele scan
// _segmented_scan :179 over the lax.sort-ed view), the carry gather, and
// _final_segment_writers (:194) + compact_set_at for the carry write. Here
// the rows stay in arrival order and a group is named by its segment id,
// `first` (the first row of its (era, key), from csrc/group_assign.cu):
//   - tile pass: each 512-row tile in shared memory; every row sums the
//     tile's earlier rows with its segment id (ascending, so a float sum has
//     one fixed order), learns whether it is the tile's last row of its
//     segment, and that row files the segment's tile total into the tile's
//     1024-slot hash table (atomicCAS on the id). The pass also marks each
//     segment's last row (atomicMax) and writes the new carry's base;
//   - row pass: a row adds the totals its segment filed in the earlier tiles
//     — only tiles from the one holding the segment's first row on, so a
//     bucket's rows look back over a few tiles — then the group's carry when
//     no reset precedes it; the last row of each final-era group writes its
//     slot's new carry (one writer per slot, no atomics on values).
// What bounds it on the card: bytes (rows x (contrib + id + slot) in, rows
// of run out, G of carry in and out: well under a microsecond at 3.35
// TB/s); the tile pass's 512-step shared-memory loop (O(tile^2) compares)
// and the launch count dominate at this size. Ints are exact; float32 sums
// run in another order than the JAX scan and agree to rounding. Float32 adds
// are XLA's CPU adds (common.cuh xla_add): a subnormal contribution reads as
// a zero of its sign and a partial sum below FLT_MIN flushes, in registers.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

__device__ __forceinline__ float sum_add(float a, float b) { return xla_add(a, b); }
__device__ __forceinline__ int64_t sum_add(int64_t a, int64_t b) { return a + b; }

constexpr int kTile = 512;   // rows per tile and threads per tile block
constexpr int kHash = 1024;  // slots of each tile's segment-total table
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned hash32(unsigned x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kTile)
tile_kernel(const T* contrib, const int32_t* first, const int32_t* bounds, const T* carry,
            int rows, int G, T* part, int32_t* seg_last, int32_t* tab_key, T* tab_val,
            T* new_carry) {
  __shared__ int32_t s_first[kTile];
  __shared__ T s_val[kTile];
  const int t = threadIdx.x;
  const int base = blockIdx.x * kTile;
  const int r = base + t;
  const int len = rows - base < kTile ? rows - base : kTile;
  if (t < len) {
    s_first[t] = first[r];
    s_val[t] = contrib[r];
  }
  __syncthreads();
  // the new carry's base: zeros when the batch holds a reset
  const bool any_reset = bounds[1] >= 0;
  for (int j = blockIdx.x * kTile + t; j < G; j += gridDim.x * kTile)
    new_carry[j] = any_reset ? T(0) : carry[j];
  if (t >= len) return;
  const int mine = s_first[t];
  T acc = T(0);
  bool later = false;
  for (int j = 0; j < len; ++j) {
    if (s_first[j] == mine) {
      if (j <= t)
        acc = sum_add(acc, s_val[j]);
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
__global__ void row_kernel(const int32_t* first, const int32_t* bounds, const T* carry,
                           const int32_t* slot, const T* part, const int32_t* seg_last,
                           const int32_t* tab_key, const T* tab_val, int rows, int G,
                           T* run, T* new_carry) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const int f = first[r];
  T cross = T(0);
  for (int tt = f / kTile; tt < r / kTile; ++tt) {
    const int32_t* keys = tab_key + (size_t)tt * kHash;
    unsigned h = hash32((unsigned)f) & (kHash - 1);
    for (;;) {
      const int k = keys[h];
      if (k == f) {
        cross = sum_add(cross, tab_val[(size_t)tt * kHash + h]);
        break;
      }
      if (k < 0) break;
      h = (h + 1) & (kHash - 1);
    }
  }
  const T seg = sum_add(cross, part[r]);
  const int s = slot[r];
  const bool live = s >= 0 && s < G;
  run[r] = sum_add(seg, r < bounds[0] && live ? carry[s] : T(0));
  if (live && r > bounds[1] && seg_last[f] == r)
    new_carry[s] = sum_add(bounds[1] >= 0 ? T(0) : carry[s], seg);
}

template <typename T>
int launch(const T* contrib, const int32_t* first, const int32_t* bounds, const T* carry,
           const int32_t* slot, int rows, int G, T* run, T* new_carry, T* part,
           int32_t* seg_last, int32_t* tab_key, T* tab_val, cudaStream_t stream) {
  const int tiles = (rows + kTile - 1) / kTile;
  cudaError_t err = cudaMemsetAsync(seg_last, 0xff, sizeof(int32_t) * (size_t)rows, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(tab_key, 0xff, sizeof(int32_t) * (size_t)tiles * kHash, stream);
  if (err != cudaSuccess) return (int)err;
  tile_kernel<T><<<tiles, kTile, 0, stream>>>(contrib, first, bounds, carry, rows, G, part,
                                              seg_last, tab_key, tab_val, new_carry);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_kernel<T><<<(rows + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      first, bounds, carry, slot, part, seg_last, tab_key, tab_val, rows, G, run, new_carry);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int keyed_running_sum_f32(const float* contrib, const int32_t* first, const int32_t* bounds,
                          const float* carry, const int32_t* slot, int rows, int G,
                          float* run, float* new_carry, float* part, int32_t* seg_last,
                          int32_t* tab_key, float* tab_val, cudaStream_t stream) {
  return launch<float>(contrib, first, bounds, carry, slot, rows, G, run, new_carry, part,
                       seg_last, tab_key, tab_val, stream);
}

int keyed_running_sum_i64(const int64_t* contrib, const int32_t* first,
                          const int32_t* bounds, const int64_t* carry, const int32_t* slot,
                          int rows, int G, int64_t* run, int64_t* new_carry, int64_t* part,
                          int32_t* seg_last, int32_t* tab_key, int64_t* tab_val,
                          cudaStream_t stream) {
  return launch<int64_t>(contrib, first, bounds, carry, slot, rows, G, run, new_carry, part,
                         seg_last, tab_key, tab_val, stream);
}

}  // extern "C"
