// Partitioned sliding time window (K31), for Hopper (sm_90a): time,
// timeLength and externalTime inside a partition.
//
// It replaces siddhi_tpu/core/partition.py's `_vmapped` step of a time
// window (windows.py:190-326, SlidingWindow.apply's time path, and :329
// `_ring_state`, once per partition under jax.vmap) and the `_flatten` that
// follows it. The JAX form runs every partition over the whole batch under
// a mask and emits [P, W + 2B] rows. Here each row carries its slot, a slot
// sees its own CURRENT rows and every TIMER row (the vmap's
// `(active & slot == p) | is_timer`), and the output comes out already in
// (position within the partition, slot) order, about P*W + 2B rows at most.
//
//   - pt_rows: each member row's rank in its slot, the slot offsets and
//     row lists, and the TIMER rows in order, from one stable sort of the
//     rows by slot (csrc/partition_rows.cuh: one block up to 2,048 rows,
//     one cooperative launch over the card above).
//   - pt_step (one block a slot): the slot's W ring elements and c batch
//     elements each find their trigger row, the earlier of the insertion W
//     later (capacity) and the first CURRENT row of the slot or TIMER row at
//     or after their own whose window time reaches theirs + t. A dying
//     element's place in the slot's output is the count of the slot's
//     CURRENT rows before its trigger plus its rank among the dying by
//     (trigger row, seq); a batch element's CURRENT is its rank plus the
//     deaths at or before its row. Each rank is a count over the slot's
//     elements, one thread an element, no sort: O((W + c)^2) a slot, which
//     is small at the shapes a partition holds. The ring after the batch,
//     the totals and the earliest live expiry (atomicMin) follow.
//   - pt_place (one block): the (position, slot) placement of every slot's
//     rows (partition.cuh place_kernel).
//   - pt_emit (one thread per output row and per element): each output
//     row's kind, ts, slot, segment head and source element, and each
//     element's birth and death rows in the flattened row space.
//   - pt_gather_{1,4,8}: the column lanes from those sources.
// What bounds it on the card: bytes (the batch lanes, the P*W ring lanes
// and the P*W + B membership lanes read or written once); the per-slot
// counting passes dominate.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "common.cuh"
#include "partition.cuh"
#include "partition_rows.cuh"

namespace {

constexpr int kStepThreads = 256;
constexpr int kThreads = 256;
constexpr int8_t kCurrent = 0, kExpired = 1;
constexpr long long kNoTimer = LLONG_MAX;

// The first entry of rows[0, n) that is > after (n when none).
__device__ __forceinline__ int first_after(const int32_t* rows, int n, int after) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rows[mid] > after) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// Element e of slot p (e < W: ring slot e; else batch rank e - W): its seq
// (-1 absent) and trigger row (INT_MAX: none).
__global__ void __launch_bounds__(kStepThreads)
pt_step_kernel(const int64_t* bwts, const int64_t* ring_seq, const int64_t* ring_wts,
               const int64_t* total, int B, int W, int P, long long t,
               const int32_t* rowlist, const int32_t* slot_start, const int32_t* timers,
               const int32_t* info, int32_t* trig, int64_t* eseq, int32_t* loc_src,
               int32_t* loc_row, int8_t* loc_kind, int32_t* n_slot, int32_t* lbirth,
               int32_t* ldeath, int32_t* ring_src, int64_t* new_seq, int64_t* new_total,
               long long* next_timer) {
  __shared__ int s_dead;
  __shared__ long long s_min;
  const int p = blockIdx.x, tid = threadIdx.x;
  const int lo = slot_start[p], c = slot_start[p + 1] - lo;
  const int T = info[3];
  const long long tot = total[p];
  const int ne = W + c;
  const int eb = p * W + lo;  // this slot's element scratch
  const int ob = p * W + 2 * lo;  // this slot's output scratch
  const int32_t* rows = rowlist + lo;
  if (tid == 0) { s_dead = 0; s_min = kNoTimer; }
  __syncthreads();
  for (int e = tid; e < ne; e += kStepThreads) {
    long long sq, target;
    int own_rank, own_row;
    long long len_rank;
    if (e < W) {
      sq = ring_seq[p * W + e];
      target = ring_wts[p * W + e] + t;
      own_rank = 0;
      own_row = -1;
      len_rank = sq + W - tot;  // the insertion that evicts it
    } else {
      const int k = e - W;
      sq = tot + k;
      own_row = rows[k];
      target = bwts[own_row] + t;
      own_rank = k;
      len_rank = k + W;
    }
    int tr = INT_MAX;
    if (sq >= 0) {
      if (len_rank >= 0 && len_rank < c) tr = rows[(int)len_rank];
      for (int i = own_rank; i < c; ++i) {
        const int r = rows[i];
        if (r >= tr) break;
        if (bwts[r] >= target) { tr = r; break; }
      }
      for (int i = first_after(timers, T, own_row - 1); i < T; ++i) {
        const int r = timers[i];
        if (r >= tr) break;
        if (bwts[r] >= target) { tr = r; break; }
      }
    }
    trig[eb + e] = tr;
    eseq[eb + e] = sq;
    if (tr != INT_MAX) atomicAdd(&s_dead, 1);
  }
  __syncthreads();
  // places in the slot's output: deaths by (trigger row, seq), each after
  // the slot's CURRENT rows before its trigger; births after the deaths at
  // or before their row
  for (int e = tid; e < ne; e += kStepThreads) {
    const int tr = trig[eb + e];
    const long long sq = eseq[eb + e];
    int birth = -1, death = sq < 0 ? -1 : INT_MAX;
    if (tr != INT_MAX) {
      int rk = 0;
      for (int e2 = 0; e2 < ne; ++e2) {
        const int t2 = trig[eb + e2];
        rk += t2 < tr || (t2 == tr && eseq[eb + e2] < sq);
      }
      death = rk + first_after(rows, c, tr - 1);
      loc_src[ob + death] = e < W ? p * W + e : P * W + rows[e - W];
      loc_row[ob + death] = tr;
      loc_kind[ob + death] = kExpired;
    }
    if (e >= W) {
      const int k = e - W, row = rows[k];
      int before = 0;
      for (int e2 = 0; e2 < ne; ++e2) before += trig[eb + e2] <= row;
      birth = k + before;
      loc_src[ob + birth] = P * W + row;
      loc_row[ob + birth] = row;
      loc_kind[ob + birth] = kCurrent;
    }
    lbirth[eb + e] = birth;
    ldeath[eb + e] = death;
  }
  // the ring after the batch: the last insertion landing on a slot if it
  // survives, else the old element, cleared when it died
  for (int j = tid; j < W; j += kStepThreads) {
    const int k = p * W + j;
    const long long sq = ring_seq[k];
    const bool old_dies = sq >= 0 && trig[eb + j] != INT_MAX;
    const int r0 = (int)(((j - tot % W) % W + W) % W);  // insertions landing here
    long long wts = 0;
    bool live = false;
    if (c > 0 && r0 <= c - 1) {
      const int r = c - 1 - (c - 1 - r0) % W;
      if (trig[eb + W + r] == INT_MAX) {
        ring_src[k] = P * W + rows[r];
        new_seq[k] = tot + r;
        wts = bwts[rows[r]];
        live = true;
      } else if (sq >= 0) {
        ring_src[k] = -1;
        new_seq[k] = -1;
      } else {
        ring_src[k] = k;
        new_seq[k] = sq;
      }
    } else if (old_dies) {
      ring_src[k] = -1;
      new_seq[k] = -1;
    } else {
      ring_src[k] = k;
      new_seq[k] = sq;
      live = sq >= 0;
      wts = ring_wts[k];
    }
    if (live) atomicMin(&s_min, wts + t);
  }
  __syncthreads();
  if (tid == 0) {
    n_slot[p] = c + s_dead;
    new_total[p] = tot + c;
    if (s_min != kNoTimer) atomicMin(next_timer, s_min);
  }
}

__global__ void pt_emit_kernel(const int64_t* batch_ts, const int32_t* slot, int B, int W,
                               int P, int n_out, const int32_t* rank,
                               const int32_t* slot_start, const int32_t* n_start,
                               const int32_t* oidx, const int32_t* info,
                               const int32_t* loc_src, const int32_t* loc_row,
                               const int8_t* loc_kind, const int32_t* lbirth,
                               const int32_t* ldeath, int64_t* out_ts, int8_t* out_kind,
                               bool* out_valid, int32_t* out_slot, int32_t* out_first,
                               int32_t* out_src, int32_t* birth, int32_t* death,
                               int64_t* elem_slot) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int PW = P * W;
  if (k < n_out) {  // item k lands at oidx[k]
    const int R = info[0];
    if (k < R) {
      const int p = slot_of_item(n_start, P, k);
      const int pos = k - n_start[p];
      const int o = oidx[k];
      const int ls = p * W + 2 * slot_start[p] + pos;
      out_ts[o] = batch_ts[loc_row[ls]];
      out_kind[o] = loc_kind[ls];
      out_valid[o] = true;
      out_slot[o] = p;
      out_first[o] = oidx[n_start[p]];
      out_src[o] = loc_src[ls];
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
    int p = -1, le = 0;
    if (k < PW) {
      p = k / W;
      le = k % W;
    } else if (rank[k - PW] >= 0) {
      p = slot[k - PW];
      le = W + rank[k - PW];
    }
    if (p < 0) {
      birth[k] = -1;
      death[k] = -1;
      elem_slot[k] = P;
    } else {
      const int e = p * W + slot_start[p] + le;
      const int b = lbirth[e], d = ldeath[e];
      birth[k] = b >= 0 ? oidx[n_start[p] + b] : b;
      death[k] = d >= 0 && d != INT_MAX ? oidx[n_start[p] + d] : d;
      elem_slot[k] = p;
    }
  }
}

}  // namespace

extern "C" {

// The bytes of pt_rows' workspace for B rows and P slots.
long long pt_rows_workspace(int B, int P) {
  RadixWork rw;
  unsigned* bins;
  return (long long)rows_carve(nullptr, B, P, &rw, &bins);
}

// rows: [P] each slot's member rows; info: [R rows, max rows of a
// slot, member rows, TIMER rows] (the first two zeroed here, for the
// placement to fill); work: pt_rows_workspace bytes
int pt_rows(const int8_t* kind, const bool* valid, const int32_t* slot, int B, int P,
            int32_t* rank, int32_t* rowlist, int32_t* slot_start, int32_t* timers,
            int32_t* rows, int32_t* info, void* work, cudaStream_t stream) {
  return launch_rows(kind, valid, slot, B, P, rank, rowlist, slot_start, timers, rows, info,
                     work, stream);
}

// next_timer must hold NO_TIMER (int64 max) on entry
int pt_step(const int64_t* bwts, const int64_t* ring_seq, const int64_t* ring_wts,
            const int64_t* total, int B, int W, int P, long long t, const int32_t* rowlist,
            const int32_t* slot_start, const int32_t* timers, const int32_t* info,
            int32_t* trig, int64_t* eseq, int32_t* loc_src, int32_t* loc_row,
            int8_t* loc_kind, int32_t* n_slot, int32_t* lbirth, int32_t* ldeath,
            int32_t* ring_src, int64_t* new_seq, int64_t* new_total, int64_t* next_timer,
            cudaStream_t stream) {
  pt_step_kernel<<<P, kStepThreads, 0, stream>>>(
      bwts, ring_seq, ring_wts, total, B, W, P, t, rowlist, slot_start, timers, info, trig,
      eseq, loc_src, loc_row, loc_kind, n_slot, lbirth, ldeath, ring_src, new_seq, new_total,
      (long long*)next_timer);
  return (int)cudaGetLastError();
}

int pt_place(int P, const int32_t* n_slot, int32_t* n_start, int32_t* pos_base, int32_t* oidx,
             int32_t* counters, int32_t* info, cudaStream_t stream) {
  place_kernel<<<1, kRankThreads, 0, stream>>>(P, n_slot, n_start, pos_base, oidx,
                                                  counters, info);
  return (int)cudaGetLastError();
}

int pt_emit(const int64_t* batch_ts, const int32_t* slot, int B, int W, int P, int n_out,
            const int32_t* rank, const int32_t* slot_start, const int32_t* n_start,
            const int32_t* oidx, const int32_t* info, const int32_t* loc_src,
            const int32_t* loc_row, const int8_t* loc_kind, const int32_t* lbirth,
            const int32_t* ldeath, int64_t* out_ts, int8_t* out_kind, bool* out_valid,
            int32_t* out_slot, int32_t* out_first, int32_t* out_src, int32_t* birth,
            int32_t* death, int64_t* elem_slot, cudaStream_t stream) {
  const int n = max(n_out, P * W + B);
  pt_emit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      batch_ts, slot, B, W, P, n_out, rank, slot_start, n_start, oidx, info, loc_src, loc_row,
      loc_kind, lbirth, ldeath, out_ts, out_kind, out_valid, out_slot, out_first, out_src,
      birth, death, elem_slot);
  return (int)cudaGetLastError();
}

// out[k] = idx[k] < 0 ? 0 : idx[k] < PW ? ring[idx[k]] : batch[idx[k] - PW]
int pt_gather_1(const void* ring, const void* batch, const int32_t* idx, void* out, int n,
                int PW, cudaStream_t stream) {
  return gather2<uint8_t>(ring, batch, idx, 0, out, n, PW, stream);
}
int pt_gather_4(const void* ring, const void* batch, const int32_t* idx, void* out, int n,
                int PW, cudaStream_t stream) {
  return gather2<uint32_t>(ring, batch, idx, 0, out, n, PW, stream);
}
int pt_gather_8(const void* ring, const void* batch, const int32_t* idx, void* out, int n,
                int PW, cudaStream_t stream) {
  return gather2<unsigned long long>(ring, batch, idx, 0, out, n, PW, stream);
}

}  // extern "C"
