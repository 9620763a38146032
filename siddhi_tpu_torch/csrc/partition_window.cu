// Partitioned length window (K29) and its windowed min/max (K30), for Hopper
// (sm_90a).
//
// K29 replaces siddhi_tpu/core/partition.py's `_vmapped` step of a length
// window under `_pstep_outer_impl` / `_pstep_inner_impl` (windows.py:352
// `_apply_length` and :329 `_ring_state` once per partition under jax.vmap)
// and the `_flatten` that follows it (partition.py:436). The JAX form runs
// every partition over the whole batch under a mask and emits a [P, 2B]
// output, about 2.8 GB for four columns at P = 1024, B = 32768, nearly all
// of it invalid lanes. Here each row carries its slot and each partition's
// output is closed-form rank arithmetic, as K1's (csrc/length_window.cu):
// with c_p rows in slot p, total_p earlier arrivals and f = max(0, W -
// total_p) free ring slots, insertion i < f emits CURRENT at position i and
// insertion i >= f its EXPIRED at f + 2(i - f) and its CURRENT one later;
// slot p has n_p = c_p + max(0, c_p - f) rows. The flattened order is
// (position, slot), so output row (pos, p) lands at
//   A(pos) + #{q < p : n_q > pos},   A(pos) = sum_q min(n_q, pos).
// Both counts are stable counting ranks (csrc/partition.cuh, shared with
// K31-K33):
//   - pw_rank (one block of 1024 threads): the rank of each member row in
//     its slot (key = slot, over the rows in order; `member_rows`), the
//     slot offsets, n_p, then `place_by_position`: A(pos) from a histogram
//     of n_p, and the rank of every (pos, p) among the items of its
//     position (key = pos, over the items listed slot by slot).
//   - pw_emit (one thread per output row and per element): each output
//     row's kind, ts, slot, segment head and source element; each element's
//     birth and death rows (the lazy membership, as K1's, in the flattened
//     row space) and slot; each ring slot's new content and seq.
//   - pw_gather_{1,4,8}: the column lanes from those sources (common.cuh
//     gather2).
// What bounds it on the card: bytes (each batch lane and ring lane read
// once, 2B output rows, P*W ring slots and P*W + B membership lanes
// written once: about 4 MB at PT's shape, ~1.2 us at 3.35 TB/s); the one
// block's counting passes (two tiles' walk per 1024 items) dominate.
//
// K30 replaces the windowed branch of siddhi_tpu/core/aggregators.py
// ExtremeAggregator.apply (:191-205) under the same vmap: per output row,
// the min/max over the elements of its own partition alive at that row.
// One thread per row reads only its slot's W ring slots and member rows
// (rowlist / slot_start from pw_rank), not K3's every element. NaN and the
// integer types follow K3 (csrc/window_extreme.cu): a NaN member sticks,
// ties keep the first in (ring slot, rank) order, an empty window gives
// the null sentinel. Cost O(rows * (W + c_p)); bound by those reads.

#include <cstdint>
#include <climits>
#include <cmath>
#include <cuda_runtime.h>

#include "common.cuh"
#include "partition.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int free_slots(int W, long long total) {
  return total >= W ? 0 : (int)(W - total);
}

// Position of insertion i's CURRENT, and (i >= f) of its EXPIRED.
__device__ __forceinline__ int cur_pos(int i, int f) { return i + max(0, i - f + 1); }
__device__ __forceinline__ int exp_pos(int i, int f) { return i + max(0, i - f + 1) - 1; }

__global__ void __launch_bounds__(kRankThreads)
pw_rank_kernel(const int8_t* kind, const bool* valid, const int32_t* slot,
               const int64_t* total, int B, int W, int P, int32_t* rank,
               int32_t* rowlist, int32_t* slot_start, int32_t* n_slot,
               int32_t* n_start, int32_t* pos_base, int32_t* oidx, int32_t* counters,
               int64_t* new_total, int32_t* info) {
  __shared__ RankSmem s;
  const int tid = threadIdx.x;
  // rank of each member row within its slot, the slot offsets
  const int C = member_rows(
      B, P,
      [&](int r) {
        const int sl = slot[r];
        return valid[r] && kind[r] == 0 && sl >= 0 && sl < P ? sl : -1;
      },
      rank, rowlist, slot_start, counters, s);
  // rows per slot, new totals
  for (int p = tid; p < P; p += kRankThreads) {
    const int c = slot_start[p + 1] - slot_start[p];
    const long long tot = total[p];
    const int f = free_slots(W, tot);
    n_slot[p] = c > 0 ? c + max(0, c - f) : 0;
    new_total[p] = tot + c;
  }
  __syncthreads();
  int maxn;
  const int R = place_by_position(P, n_slot, n_start, pos_base, oidx, counters, &maxn, s);
  if (tid == 0) {
    info[0] = R;
    info[1] = maxn;
    info[2] = C;
  }
}

__global__ void pw_emit_kernel(const int64_t* batch_ts, const int32_t* slot,
                               const int64_t* ring_seq, const int64_t* total, int B, int W,
                               int P, const int32_t* rank, const int32_t* rowlist,
                               const int32_t* slot_start, const int32_t* n_start,
                               const int32_t* oidx, const int32_t* info, int64_t* out_ts,
                               int8_t* out_kind, bool* out_valid, int32_t* out_slot,
                               int32_t* out_first, int32_t* out_src, int32_t* birth,
                               int32_t* death, int64_t* elem_slot, int32_t* ring_src,
                               int64_t* new_seq) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int PW = P * W;
  if (k < 2 * B) {  // output row k (item k lands at oidx[k])
    const int R = info[0];
    if (k < R) {
      const int p = slot_of_item(n_start, P, k);
      const int pos = k - n_start[p];
      const int o = oidx[k];
      const int lo = slot_start[p];
      const long long tot = total[p];
      const int f = free_slots(W, tot);
      int i, cur;
      if (pos < f) {
        i = pos;
        cur = 1;
      } else {
        i = f + (pos - f) / 2;
        cur = (pos - f) & 1;
      }
      const int row = rowlist[lo + i];
      int src = PW + row;
      if (!cur) {  // EXPIRED: the element inserted W insertions earlier
        src = i < W ? p * W + (int)((tot + i - W) % W) : PW + rowlist[lo + i - W];
      }
      out_ts[o] = batch_ts[row];
      out_kind[o] = cur ? 0 : 1;
      out_valid[o] = true;
      out_slot[o] = p;
      out_first[o] = oidx[n_start[p]];
      out_src[o] = src;
    } else {
      out_ts[k] = 0;
      out_kind[k] = 0;
      out_valid[k] = false;
      out_slot[k] = P;
      out_first[k] = k;
      out_src[k] = -1;
    }
  }
  if (k < PW + B) {  // element k: ring slot, then batch row
    if (k < PW) {
      const int p = k / W, j = k % W;
      const long long sq = ring_seq[k];
      const long long tot = total[p];
      const int lo = slot_start[p], c = slot_start[p + 1] - lo;
      const int f = free_slots(W, tot);
      const long long t = sq + W - tot;  // the insertion rank that evicts it
      const bool evict = sq >= 0 && t >= 0 && t < c;
      birth[k] = -1;
      death[k] = sq < 0 ? -1 : evict ? oidx[n_start[p] + exp_pos((int)t, f)] : INT_MAX;
      elem_slot[k] = p;
      const int r0 = (int)(((j - tot % W) % W + W) % W);  // insertions landing here
      if (c > 0 && r0 <= c - 1) {
        const int r = c - 1 - (c - 1 - r0) % W;
        ring_src[k] = PW + rowlist[lo + r];
        new_seq[k] = tot + r;
      } else if (evict) {
        ring_src[k] = -1;
        new_seq[k] = -1;
      } else {
        ring_src[k] = k;
        new_seq[k] = sq;
      }
    } else {
      const int r = k - PW;
      const int i = rank[r];
      if (i >= 0) {
        const int p = slot[r];
        const int c = slot_start[p + 1] - slot_start[p];
        const int f = free_slots(W, total[p]);
        birth[k] = oidx[n_start[p] + cur_pos(i, f)];
        death[k] = i + W < c ? oidx[n_start[p] + exp_pos(i + W, f)] : INT_MAX;
        elem_slot[k] = p;
      } else {
        birth[k] = -1;
        death[k] = -1;
        elem_slot[k] = P;
      }
    }
  }
}

template <typename T> struct Limits;
template <> struct Limits<float> {
  __device__ static float hi() { return INFINITY; }
  __device__ static float lo() { return -INFINITY; }
  __device__ static bool nan(float v) { return isnan(v); }
  // a float32 subnormal reads as a zero of its sign, as XLA's CPU code reads it
  __device__ static float read(float v) { return flush_subnormal(v); }
  __device__ static float from_bits(long long b) { return __int_as_float((int)b); }
};
template <> struct Limits<int32_t> {
  __device__ static int32_t hi() { return INT_MAX; }
  __device__ static int32_t lo() { return INT_MIN; }
  __device__ static bool nan(int32_t) { return false; }
  __device__ static int32_t read(int32_t v) { return v; }
  __device__ static int32_t from_bits(long long b) { return (int32_t)b; }
};
template <> struct Limits<int64_t> {
  __device__ static int64_t hi() { return LLONG_MAX; }
  __device__ static int64_t lo() { return LLONG_MIN; }
  __device__ static bool nan(int64_t) { return false; }
  __device__ static int64_t read(int64_t v) { return v; }
  __device__ static int64_t from_bits(long long b) { return (int64_t)b; }
};

template <typename T>
__device__ __forceinline__ void fold(T& red, T v, bool is_min) {
  const bool take = Limits<T>::nan(v) || (is_min ? v < red : v > red);
  if (take && !Limits<T>::nan(red)) red = v;
}

template <typename T>
__global__ void pw_extreme_kernel(const T* vals, const int32_t* birth, const int32_t* death,
                                  const int32_t* row_slot, const int32_t* rowlist,
                                  const int32_t* slot_start, T* out, int n_rows, int P, int W,
                                  int is_min, long long null_bits) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n_rows) return;
  const T ident = is_min ? Limits<T>::hi() : Limits<T>::lo();
  const int p = row_slot[o];
  T red = ident;
  if (p >= 0 && p < P) {
    for (int j = 0; j < W; ++j) {
      const int e = p * W + j;
      if (birth[e] <= o && o < death[e]) fold(red, Limits<T>::read(vals[e]), is_min);
    }
    const int hi = slot_start[p + 1];
    for (int k = slot_start[p]; k < hi; ++k) {
      const int e = P * W + rowlist[k];
      if (birth[e] <= o && o < death[e]) fold(red, Limits<T>::read(vals[e]), is_min);
    }
  }
  out[o] = red == ident ? Limits<T>::from_bits(null_bits) : red;
}

template <typename T>
int pw_extreme(const T* vals, const int32_t* birth, const int32_t* death,
               const int32_t* row_slot, const int32_t* rowlist, const int32_t* slot_start,
               T* out, int n_rows, int P, int W, int is_min, long long null_bits,
               cudaStream_t stream) {
  if (n_rows <= 0) return 0;
  pw_extreme_kernel<T><<<(n_rows + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      vals, birth, death, row_slot, rowlist, slot_start, out, n_rows, P, W, is_min, null_bits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// counters: [max(P, 2B) + 1] int32 scratch; pos_base: [2B + 1]; info:
// [R rows, max rows of a slot, member rows, -]
int pw_rank(const int8_t* kind, const bool* valid, const int32_t* slot, const int64_t* total,
            int B, int W, int P, int32_t* rank, int32_t* rowlist, int32_t* slot_start,
            int32_t* n_slot, int32_t* n_start, int32_t* pos_base, int32_t* oidx,
            int32_t* counters, int64_t* new_total, int32_t* info, cudaStream_t stream) {
  pw_rank_kernel<<<1, kRankThreads, 0, stream>>>(kind, valid, slot, total, B, W, P, rank,
                                                 rowlist, slot_start, n_slot, n_start,
                                                 pos_base, oidx, counters, new_total, info);
  return (int)cudaGetLastError();
}

int pw_emit(const int64_t* batch_ts, const int32_t* slot, const int64_t* ring_seq,
            const int64_t* total, int B, int W, int P, const int32_t* rank,
            const int32_t* rowlist, const int32_t* slot_start, const int32_t* n_start,
            const int32_t* oidx, const int32_t* info, int64_t* out_ts, int8_t* out_kind,
            bool* out_valid, int32_t* out_slot, int32_t* out_first, int32_t* out_src,
            int32_t* birth, int32_t* death, int64_t* elem_slot, int32_t* ring_src,
            int64_t* new_seq, cudaStream_t stream) {
  const int n = max(2 * B, P * W + B);
  pw_emit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      batch_ts, slot, ring_seq, total, B, W, P, rank, rowlist, slot_start, n_start, oidx,
      info, out_ts, out_kind, out_valid, out_slot, out_first, out_src, birth, death,
      elem_slot, ring_src, new_seq);
  return (int)cudaGetLastError();
}

// out[k] = idx[k] < 0 ? 0 : idx[k] < PW ? ring[idx[k]] : batch[idx[k] - PW]
int pw_gather_1(const void* ring, const void* batch, const int32_t* idx, void* out, int n,
                int PW, cudaStream_t stream) {
  return gather2<uint8_t>(ring, batch, idx, 0, out, n, PW, stream);
}
int pw_gather_4(const void* ring, const void* batch, const int32_t* idx, void* out, int n,
                int PW, cudaStream_t stream) {
  return gather2<uint32_t>(ring, batch, idx, 0, out, n, PW, stream);
}
int pw_gather_8(const void* ring, const void* batch, const int32_t* idx, void* out, int n,
                int PW, cudaStream_t stream) {
  return gather2<unsigned long long>(ring, batch, idx, 0, out, n, PW, stream);
}

#define PW_EXTREME(SUFFIX, T)                                                            \
  int pw_extreme_##SUFFIX(const T* vals, const int32_t* birth, const int32_t* death,     \
                          const int32_t* row_slot, const int32_t* rowlist,               \
                          const int32_t* slot_start, T* out, int n_rows, int P, int W,    \
                          int is_min, long long null_bits, cudaStream_t stream) {         \
    return pw_extreme<T>(vals, birth, death, row_slot, rowlist, slot_start, out, n_rows, \
                         P, W, is_min, null_bits, stream);                              \
  }

PW_EXTREME(f32, float)
PW_EXTREME(i32, int32_t)
PW_EXTREME(i64, int64_t)

}  // extern "C"
