// lengthBatch window step: B arrivals into tumbling buckets of n, for Hopper
// (sm_90a).
//
// Replaces siddhi_tpu/core/windows.py BatchWindow.apply, lengthBatch branch
// (:553-895): candidate keys row_of_flush*4 + kindbit, one multi-operand
// lax.sort of 3n + 2B + F candidates (n + B + F without the EXPIRED lanes),
// the inverse permutation for membership, and compact_set_at for the open
// and previous buckets. Here the sort is replaced by the flush arithmetic:
// with c valid CURRENT arrivals and cur_n0 carried rows, n_flush =
// (cur_n0 + c) / n flushes happen, and flush f emits, in order,
//   1. the previous bucket's EXPIRED rows (prev_n of them at f = 0, n after;
//      only with the EXPIRED lanes on), with the trigger row's ts;
//   2. one RESET row carrying the carried bucket's first element cur[0];
//   3. the bucket's n CURRENT rows: carried rows first at f = 0, then batch
//      rows in arrival order.
// So flush f starts at a closed-form position S_f, every output slot inverts
// to (flush, offset) and then to its source element, and every lane is a
// gather:
//   - rank/perm: one exclusive scan of the valid-CURRENT mask in ONE block
//     (1024 threads x 32 rows per tile, a carried offset across tiles);
//   - out rows: source element (carried slot, previous-bucket slot or batch
//     row), kind, valid and ts per slot; padding rows are zero, valid false;
//   - membership stays lazy: birth/death [2n + B] int32 lanes over (carried,
//     previous, batch) elements, never the [rows, 2n + B] matrix of the JAX
//     step (4.7 GB of bools at B = 32768, n = 1024);
//   - the new open and previous buckets: a source per slot, gathered.
// What bounds it on the card: bytes (B rows + 2n buffer slots in; rows out
// rows + 2(2n + B) positions + 2n slots out), a few MB at B = 32768, i.e.
// microseconds at 3.35 TB/s; the single scan block and the launch count
// (4 + one gather per lane and buffer) dominate at this size. No host sync:
// c, n_flush and the new counts stay in device memory.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 32;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kThreads = 256;
constexpr int kBig = INT_MAX;

// rank[r] (or -1), perm[rank] = r and the count c of valid CURRENT rows.
__global__ void __launch_bounds__(kScanThreads)
rank_kernel(const int8_t* kind, const bool* valid, int B, int32_t* rank, int32_t* perm,
            int32_t* count) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x;
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
        ++excl;
      } else {
        rank[r] = -1;
      }
    }
    carry += tile_total;
  }
  if (tid == 0) *count = carry;
}

// The step's scalars, read from device memory by every thread.
struct Plan {
  long long c, cur_n0, prev_n, n_flush;
  int n, w;
  bool exp;

  __device__ Plan(const int32_t* count, const int32_t* cur_n, const int32_t* prev_n_,
                  int n_, bool exp_)
      : c(*count), cur_n0(*cur_n), prev_n(*prev_n_), n_flush(0), n(n_), w(n_), exp(exp_) {
    n_flush = (cur_n0 + c) / n;
  }
  // EXPIRED rows of flush f
  __device__ long long expired(long long f) const {
    return exp ? (f == 0 ? prev_n : n) : 0;
  }
  // first output row of flush f
  __device__ long long start(long long f) const {
    if (!exp) return f * (n + 1);
    return f == 0 ? 0 : prev_n + f * (n + 1) + (f - 1) * n;
  }
  // element index of bucket b's q-th element: carried slot q, or 2w + row
  __device__ int bucket_elem(const int32_t* perm, long long b, long long q) const {
    if (b == 0 && q < cur_n0) return (int)q;
    return 2 * w + perm[b * n + q - cur_n0];
  }
  // the batch row whose arrival completes bucket f
  __device__ int trigger_row(const int32_t* perm, long long f) const {
    return perm[(f + 1) * n - 1 - cur_n0];
  }
};

// Per output row p: its source element, kind, ts and valid.
__global__ void index_kernel(const int32_t* count, const int32_t* cur_n,
                             const int32_t* prev_n, const int32_t* perm,
                             const int64_t* batch_ts, const int64_t* cur_ts, int n,
                             int rows, int exp, int32_t* out_src, int64_t* out_ts,
                             int8_t* out_kind, bool* out_valid) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= rows) return;
  const Plan pl(count, cur_n, prev_n, n, exp != 0);
  long long f, o;
  if (pl.exp) {
    const long long s1 = pl.prev_n + n + 1;
    if (p < s1) {
      f = 0;
      o = p;
    } else {
      f = 1 + (p - s1) / (2LL * n + 1);
      o = (p - s1) % (2LL * n + 1);
    }
  } else {
    f = p / (n + 1LL);
    o = p % (n + 1LL);
  }
  int src = -1, kind = 0;
  long long ts = 0;
  if (f < pl.n_flush) {
    const long long e = pl.expired(f);
    if (o < e) {  // EXPIRED: the bucket closed at flush f - 1 (or prev)
      kind = 1;
      src = f == 0 ? pl.w + (int)o : pl.bucket_elem(perm, f - 1, o);
      ts = batch_ts[pl.trigger_row(perm, f)];
    } else if (o == e) {  // RESET
      kind = 3;
      src = 0;
      ts = cur_ts[0];
    } else {  // CURRENT
      src = pl.bucket_elem(perm, f, o - e - 1);
      ts = src < pl.w ? cur_ts[src] : batch_ts[src - 2 * pl.w];
    }
  }
  out_src[p] = src;
  out_ts[p] = ts;
  out_kind[p] = (int8_t)kind;
  out_valid[p] = src >= 0;
}

// Per element e of [carried n | previous n | batch B]: the output rows
// birth <= p < death in which it is in the window.
__global__ void elem_kernel(const int32_t* count, const int32_t* cur_n,
                            const int32_t* prev_n, const int32_t* rank, int B, int n,
                            int32_t* birth, int32_t* death) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const Plan pl(count, cur_n, prev_n, n, true);
  const int w = pl.w;
  if (e >= 2 * w + B) return;
  long long b = kBig, d = kBig;
  if (e < w) {
    if (e < pl.cur_n0 && pl.n_flush >= 1) b = pl.start(0) + pl.expired(0) + 1 + e;
    if (e < pl.cur_n0 && pl.n_flush > 1) d = pl.start(1) + e;
  } else if (e < 2 * w) {
    d = -1;
  } else {
    const int rk = rank[e - 2 * w];
    if (rk >= 0) {
      const long long pos = pl.cur_n0 + rk;
      const long long bk = pos / n, q = pos - bk * n;
      if (bk < pl.n_flush) {
        b = pl.start(bk) + pl.expired(bk) + 1 + q;
        if (bk + 1 < pl.n_flush) d = pl.start(bk + 1) + q;
      }
    }
  }
  birth[e] = (int)b;
  death[e] = (int)d;
}

// Per buffer slot j: where the new open and previous buckets' contents come
// from (-1 = zero), and the new counts.
__global__ void state_kernel(const int32_t* count, const int32_t* cur_n,
                             const int32_t* prev_n, const int32_t* perm, int n,
                             int32_t* cur_src, int32_t* prev_src, int32_t* new_cur_n,
                             int32_t* new_prev_n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const Plan pl(count, cur_n, prev_n, n, true);
  const int w = pl.w;
  if (j >= w) return;
  if (pl.n_flush == 0) {
    cur_src[j] = (j >= pl.cur_n0 && j < pl.cur_n0 + pl.c) ? 2 * w + perm[j - pl.cur_n0] : j;
    prev_src[j] = w + j;
  } else {
    const long long rem = pl.cur_n0 + pl.c - pl.n_flush * n;
    cur_src[j] = j < rem ? 2 * w + perm[pl.n_flush * n - pl.cur_n0 + j] : -1;
    prev_src[j] = pl.bucket_elem(perm, pl.n_flush - 1, j);
  }
  if (j == 0) {
    *new_cur_n = (int32_t)(pl.n_flush == 0 ? pl.cur_n0 + pl.c
                                           : pl.cur_n0 + pl.c - pl.n_flush * n);
    *new_prev_n = (int32_t)(pl.n_flush == 0 ? pl.prev_n : n);
  }
}

template <typename T>
__global__ void gather_kernel(const T* cur, const T* prev, const T* batch,
                              const int32_t* idx, T* out, int count, int w) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= count) return;
  const int i = idx[k];
  out[k] = i < 0 ? T(0) : (i < w ? cur[i] : (i < 2 * w ? prev[i - w] : batch[i - 2 * w]));
}

template <typename T>
int gather(const void* cur, const void* prev, const void* batch, const int32_t* idx,
           void* out, int count, int w, cudaStream_t stream) {
  gather_kernel<T><<<(count + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      (const T*)cur, (const T*)prev, (const T*)batch, idx, (T*)out, count, w);
  return (int)cudaGetLastError();
}

int blocks(long long count) { return (int)((count + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

int bw_prepare(const int8_t* kind, const bool* valid, const int64_t* batch_ts,
               const int64_t* cur_ts, const int32_t* cur_n, const int32_t* prev_n,
               int B, int n, int rows, int exp, int32_t* rank, int32_t* perm,
               int32_t* count, int32_t* out_src, int64_t* out_ts, int8_t* out_kind,
               bool* out_valid, int32_t* birth, int32_t* death, int32_t* cur_src,
               int32_t* prev_src, int32_t* new_cur_n, int32_t* new_prev_n,
               cudaStream_t stream) {
  rank_kernel<<<1, kScanThreads, 0, stream>>>(kind, valid, B, rank, perm, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  index_kernel<<<blocks(rows), kThreads, 0, stream>>>(
      count, cur_n, prev_n, perm, batch_ts, cur_ts, n, rows, exp, out_src, out_ts,
      out_kind, out_valid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (exp) {
    elem_kernel<<<blocks(2LL * n + B), kThreads, 0, stream>>>(count, cur_n, prev_n, rank,
                                                               B, n, birth, death);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  state_kernel<<<blocks(n), kThreads, 0, stream>>>(count, cur_n, prev_n, perm, n, cur_src,
                                                   prev_src, new_cur_n, new_prev_n);
  return (int)cudaGetLastError();
}

// out[k] = idx < 0 ? 0 : idx < w ? cur[idx] : idx < 2w ? prev[idx - w] : batch[idx - 2w]
int bw_gather_1(const void* cur, const void* prev, const void* batch, const int32_t* idx,
                void* out, int count, int w, cudaStream_t stream) {
  return gather<uint8_t>(cur, prev, batch, idx, out, count, w, stream);
}
int bw_gather_4(const void* cur, const void* prev, const void* batch, const int32_t* idx,
                void* out, int count, int w, cudaStream_t stream) {
  return gather<uint32_t>(cur, prev, batch, idx, out, count, w, stream);
}
int bw_gather_8(const void* cur, const void* prev, const void* batch, const int32_t* idx,
                void* out, int count, int w, cudaStream_t stream) {
  return gather<unsigned long long>(cur, prev, batch, idx, out, count, w, stream);
}

}  // extern "C"
