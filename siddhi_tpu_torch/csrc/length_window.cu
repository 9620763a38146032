// Length-window step: B arrivals into a W-slot ring, for Hopper (sm_90a).
//
// Replaces siddhi_tpu/core/windows.py SlidingWindow._apply_length, with the
// rank/perm of SlidingWindow.apply (:190-239), SlidingWindow._ring_state and
// _place_ring. The JAX step sorts (argsort of the CURRENT mask), takes a
// cumsum of eviction flags, scatters EXPIRED/CURRENT rows into 2B output
// slots and builds a [2B, W+B] membership matrix. Here every one of those is
// closed-form rank arithmetic:
//   - rank/perm: one exclusive scan of the valid-CURRENT mask in ONE block
//     (1024 threads x 32 rows = a 32768-row tile; larger batches loop over
//     tiles with a carried offset). c = the count, left on the device.
//   - E_i (evictions up to insertion i) = max(0, i - s + 1), s = max(0, W -
//     total): insertion i < s emits CURRENT at i; insertion i >= s emits its
//     EXPIRED at 2i - s and its CURRENT at 2i - s + 1. So each of the 2B
//     output positions inverts to (insertion, kind) with no scatter, and a
//     gather per lane fills it.
//   - ring update: slot j takes the unique insertion r in [max(0,c-W), c)
//     with (total + r) % W == j, else it is cleared if evicted, else kept;
//     again a gather, so no two threads write one slot.
//   - membership stays lazy: birth_pos/death_pos [W+B] int32 lanes (element
//     e is in the window for output rows birth <= p < death; absent elements
//     get death = -1), never the [2B, W+B] matrix (2.1 GB at B = 32768).
// What bounds it on the card: bytes. Each lane is read once and written
// once (ring W slots + B rows in, 2B rows + W slots + 2(W+B) positions out),
// a few MB per step at B = 32768, i.e. microseconds at 3.35 TB/s; the single
// scan block and the launch count (3 + one gather per lane) dominate at
// this size. No host sync: total and c stay in device memory.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 32;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kThreads = 256;

__device__ __forceinline__ long long first_evicting(int W, long long total) {
  long long s = (long long)W - total;
  return s < 0 ? 0 : s;
}

// rank[r] (or -1), perm[rank] = r, birth of batch rows, and c.
__global__ void rank_kernel(const int8_t* kind, const bool* valid, int B, int W,
                            const int64_t* total, int32_t* rank, int32_t* perm,
                            int32_t* birth, int32_t* count) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x;
  const long long s = first_evicting(W, *total);
  int carry = 0;
  for (int base = 0; base < B; base += kScanTile) {
    const int start = base + tid * kScanItems;
    unsigned flags = 0;
    int local = 0;
    for (int k = 0; k < kScanItems; ++k) {
      const int r = start + k;
      const bool vc = r < B && valid[r] && kind[r] == 0;
      flags |= (unsigned)vc << k;
      local += vc;
    }
    int tile_total;
    int excl = carry + block_excl_sum(local, warp_sums, &tile_total);
    for (int k = 0; k < kScanItems; ++k) {
      const int r = start + k;
      if (r >= B) break;
      if ((flags >> k) & 1u) {
        rank[r] = excl;
        perm[excl] = r;
        long long e = (long long)excl - s + 1;
        birth[W + r] = excl + (int)(e < 0 ? 0 : e);
        ++excl;
      } else {
        rank[r] = -1;
        birth[W + r] = -1;
      }
    }
    carry += tile_total;
  }
  if (tid == 0) *count = carry;
}

// Per element e of [ring slots | batch rows]: death position (and birth of
// the ring part); per ring slot: where its new content comes from.
__global__ void elem_kernel(const int64_t* ring_seq, const int64_t* total,
                            const int32_t* count, const int32_t* rank,
                            const int32_t* perm, int B, int W, int32_t* birth,
                            int32_t* death, int32_t* ring_src, int64_t* new_seq,
                            int64_t* new_total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= W + B) return;
  const long long tot = *total;
  const long long c = *count;
  const long long s = first_evicting(W, tot);
  bool present;
  long long t;  // the insertion rank that evicts e
  if (e < W) {
    const long long sq = ring_seq[e];
    present = sq >= 0;
    t = sq + W - tot;
    birth[e] = -1;
  } else {
    const int rk = rank[e - W];
    present = rk >= 0;
    t = (long long)rk + W;
  }
  const bool evict = present && t >= 0 && t < c;
  death[e] = !present ? -1 : (evict ? (int)(2 * t - s) : INT_MAX);
  if (e < W) {
    const long long r0 = c > W ? c - W : 0;
    const long long r = r0 + (((e - tot - r0) % W) + W) % W;
    if (r < c) {
      ring_src[e] = W + perm[r];
      new_seq[e] = tot + r;
    } else if (evict) {
      ring_src[e] = -1;
      new_seq[e] = -1;
    } else {
      ring_src[e] = e;
      new_seq[e] = ring_seq[e];
    }
  }
  if (e == 0) *new_total = tot + c;
}

// Per output position p in [0, 2B): its source element, kind, ts and valid.
__global__ void index_kernel(const int64_t* total, const int32_t* count,
                             const int32_t* perm, const int64_t* batch_ts, int B,
                             int W, int32_t* out_src, int64_t* out_ts,
                             int8_t* out_kind, bool* out_valid) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= 2 * B) return;
  const long long tot = *total;
  const long long c = *count;
  const long long s = first_evicting(W, tot);
  int src = -1, row = 0, kind = 0;
  if (p < (s < c ? s : c)) {
    row = perm[p];
    src = W + row;
  } else if (c > s && p < 2 * c - s) {
    const long long q = p - s;
    const long long i = s + q / 2;
    row = perm[i];
    if (q & 1) {
      src = W + row;
    } else {
      kind = 1;  // EXPIRED: the element inserted W insertions earlier
      src = i < W ? (int)((tot + i - W) % W) : W + perm[i - W];
    }
  }
  const bool v = src >= 0;
  out_src[p] = src;
  out_valid[p] = v;
  out_kind[p] = v ? (int8_t)kind : (int8_t)0;
  out_ts[p] = v ? batch_ts[row] : 0;
}

}  // namespace

extern "C" {

int lw_prepare(const int8_t* kind, const bool* valid, const int64_t* batch_ts,
               const int64_t* ring_seq, const int64_t* total, int B, int W,
               int32_t* rank, int32_t* perm, int32_t* count, int32_t* birth,
               int32_t* death, int32_t* out_src, int64_t* out_ts,
               int8_t* out_kind, bool* out_valid, int32_t* ring_src,
               int64_t* new_seq, int64_t* new_total, cudaStream_t stream) {
  rank_kernel<<<1, kScanThreads, 0, stream>>>(kind, valid, B, W, total, rank,
                                              perm, birth, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  elem_kernel<<<(W + B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      ring_seq, total, count, rank, perm, B, W, birth, death, ring_src, new_seq,
      new_total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  index_kernel<<<(2 * B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      total, count, perm, batch_ts, B, W, out_src, out_ts, out_kind, out_valid);
  return (int)cudaGetLastError();
}

// out[k] = idx[k] < 0 ? 0 : idx[k] < W ? ring[idx[k]] : batch[idx[k] - W]
int lw_gather_1(const void* ring, const void* batch, const int32_t* idx,
                void* out, int n, int W, cudaStream_t stream) {
  return gather2<uint8_t>(ring, batch, idx, 0, out, n, W, stream);
}
int lw_gather_4(const void* ring, const void* batch, const int32_t* idx,
                void* out, int n, int W, cudaStream_t stream) {
  return gather2<uint32_t>(ring, batch, idx, 0, out, n, W, stream);
}
int lw_gather_8(const void* ring, const void* batch, const int32_t* idx,
                void* out, int n, int W, cudaStream_t stream) {
  return gather2<unsigned long long>(ring, batch, idx, 0, out, n, W, stream);
}

}  // extern "C"
