// Partitioned batch window (K32), for Hopper (sm_90a): lengthBatch,
// timeBatch and externalTimeBatch inside a partition.
//
// It replaces siddhi_tpu/core/partition.py's `_vmapped` step of a batch
// window (windows.py:553-873, BatchWindow.apply: the lengthBatch branch,
// the time branch with its positional idle-timeout flush, the emission and
// the buffers, once per partition under jax.vmap) and the `_flatten` that
// follows it. Each row carries its slot; a slot sees its own CURRENT rows
// and every TIMER row (the vmap's `(active & slot == p) | is_timer`), so a
// TIMER row moves every slot's clock, used or not. The output comes out
// already in (position within the partition, slot) order.
//
//   - the row lists: each member row's rank in its slot, the slot offsets
//     and row lists, and the TIMER rows in order, come from K31's `pt_rows`
//     (csrc/partition_time.cu, on csrc/partition_rows.cuh).
//   - pb_step (one thread a slot): the slot's rows and the TIMER rows
//     merged in row order, walked once. A lengthBatch bucket flushes at the
//     row that fills it; a time bucket at the first trigger row (CURRENT or
//     TIMER) of a later bucket of the grid, or at a TIMER row with no
//     CURRENT row of the slot before it once the idle deadline has passed.
//     Every flush emits the previous bucket's EXPIRED rows (with the
//     trigger row's ts, when the EXPIRED lanes are on), one RESET row (the
//     open bucket's first element on entry), then the closing bucket's
//     CURRENT rows, into the slot's own stretch of a scratch; the walk also
//     records each element's birth and death place, the sources of the
//     [P, w] open and previous buckets after the batch, the counts, the
//     bucket start and idle deadline, and the earliest timer (atomicMin).
//     The same rules as the unpartitioned K6/K17 (csrc/batch_window.cu)
//     on the slot's rows, one slot at a time.
//   - pb_place (one block): the (position, slot) placement of every slot's
//     rows (partition.cuh place_kernel).
//   - pb_emit (one thread per output row and per element): each output
//     row's kind, ts, slot, segment head and source, and each element's
//     birth and death rows in the flattened row space.
//   - pb_gather_{1,4,8}: the column lanes from [open buckets | previous
//     buckets | batch], the element of slot p's bucket slot j being
//     p * 2w + j (open) or p * 2w + w + j (previous), a batch row 2Pw + r.
// What bounds it on the card: bytes (the batch lanes and the [P, w] buffer
// lanes read once, the output rows and the new buffers written once); the
// one-thread-a-slot walk is the simple form, a slot's rows in sequence.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "common.cuh"
#include "partition.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlotThreads = 64;
constexpr int8_t kCurrent = 0, kExpired = 1, kReset = 3;
constexpr long long kNoTimer = LLONG_MAX;
constexpr int kBig = INT_MAX;
// next_timer modes (core/windows.py TIMER_*)
constexpr int kTimerBucket = 1, kTimerTimeout = 2;

struct Params {
  int B, w, P, n, timed, emit, has_start, timer_mode;
  long long t, start, timeout;
};

// One slot's output stretch: appends a row and records its source.
struct Out {
  int32_t* src;
  int32_t* row;
  int8_t* kind;
  int n;
  __device__ int put(int s, int r, int8_t k) {
    src[n] = s;
    row[n] = r;
    kind[n] = k;
    return n++;
  }
};

__global__ void __launch_bounds__(kSlotThreads)
pb_step_kernel(Params a, const int64_t* wts, const int32_t* rowlist, const int32_t* slot_start,
               const int32_t* timers, const int32_t* info, const int32_t* cur_n,
               const int32_t* prev_n, const int64_t* bucket_start, const int64_t* deadline,
               const int64_t* now_p, int32_t* loc_src, int32_t* loc_row, int8_t* loc_kind,
               int32_t* n_slot, int32_t* lbirth, int32_t* ldeath, int32_t* cur_src,
               int32_t* prev_src, int32_t* new_cur_n, int32_t* new_prev_n, int64_t* new_bs,
               int64_t* new_dl, long long* next_timer) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= a.P) return;
  const int w = a.w, T = a.timed ? info[3] : 0;  // lengthBatch takes no TIMER row
  const int lo = slot_start[p], c = slot_start[p + 1] - lo;
  const int32_t* rows = rowlist + lo;
  const int cur0 = cur_n[p], prev0 = prev_n[p];
  const int cc = min(cur0, w), pc = min(prev0, w);
  const long long bs = bucket_start[p], dl = deadline[p], now = *now_p;
  const int stride = (a.emit ? 3 * w : w) + T + 1;
  Out o{loc_src, loc_row, loc_kind, 0};
  {
    const long long ob = (long long)p * stride + (a.emit ? 3 : 2) * (long long)lo;
    o.src += ob;
    o.row += ob;
    o.kind += ob;
  }
  const int eb = p * 2 * w + lo;  // elements: open w | previous w | batch c
  const int cur_e = p * 2 * w, prev_e = cur_e + w, bat_e = 2 * a.P * w;
  if (a.emit) {
    for (int j = 0; j < w; ++j) {
      lbirth[eb + j] = kBig;
      ldeath[eb + j] = kBig;
      lbirth[eb + w + j] = kBig;
      ldeath[eb + w + j] = -1;
    }
    for (int k = 0; k < c; ++k) {
      lbirth[eb + 2 * w + k] = kBig;
      ldeath[eb + 2 * w + k] = kBig;
    }
  }
  // the time grid on entry
  long long start0 = -1;
  const int n_items = a.timed ? c + T : c;
  if (a.timed) {
    if (a.has_start) start0 = a.start;
    else if (bs >= 0) start0 = bs;
    else if (n_items > 0) {
      const int r0 = c > 0 && (T == 0 || rows[0] < timers[0]) ? rows[0] : timers[0];
      start0 = wts[r0];
    }
  }
  const long long carried_g = a.timed && bs >= 0 ? max(bs - start0, 0LL) / a.t : 0;
  long long open = carried_g;
  bool had = bs >= 0;
  int f = 0, k = 0, ti = 0, open_k = 0, plo = 0, phi = 0;
  for (int it = 0; it < n_items; ++it) {
    // the next item in row order: a CURRENT row of the slot or a TIMER row
    bool is_cur;
    int r;
    if (!a.timed) {
      is_cur = true;
      r = rows[k];
    } else if (k < c && (ti >= T || rows[k] < timers[ti])) {
      is_cur = true;
      r = rows[k];
    } else {
      is_cur = false;
      r = timers[ti++];
    }
    bool flush;
    int chi;  // the closing bucket's ranks end
    if (!a.timed) {
      flush = (cur0 + k + 1) % a.n == 0;
      chi = k + 1;
    } else {
      const long long g = start0 >= 0 ? max(wts[r] - start0, 0LL) / a.t : 0;
      flush = g > open && had;
      if (a.timer_mode == kTimerTimeout && !is_cur && k == 0 && cur0 > 0 && now >= dl)
        flush = true;
      open = max(open, g);
      had = true;
      chi = k;
    }
    if (flush) {
      if (a.emit) {
        if (f == 0) {
          for (int j = 0; j < pc; ++j) o.put(prev_e + j, r, kExpired);
        } else {
          if (f == 1) {
            for (int j = 0; j < cc; ++j) ldeath[eb + j] = o.put(cur_e + j, r, kExpired);
          }
          for (int q = plo; q < phi; ++q)
            ldeath[eb + 2 * w + q] = o.put(bat_e + rows[q], r, kExpired);
        }
      }
      o.put(cur_e, -1, kReset);
      if (f == 0) {
        for (int j = 0; j < cc; ++j) {
          const int at = o.put(cur_e + j, -1, kCurrent);
          if (a.emit) lbirth[eb + j] = at;
        }
      }
      for (int q = open_k; q < chi; ++q) {
        const int at = o.put(bat_e + rows[q], -1, kCurrent);
        if (a.emit) lbirth[eb + 2 * w + q] = at;
      }
      plo = open_k;
      phi = chi;
      open_k = chi;
      ++f;
    }
    if (is_cur) ++k;
  }
  n_slot[p] = o.n;
  // the open bucket and the last flushed one after the batch
  const int base = p * w;
  const int rem = c - open_k;
  const int keep = f == 0 ? cur0 : 0;
  for (int j = 0; j < w; ++j) cur_src[base + j] = f == 0 ? cur_e + j : -1;
  for (int q = 0; q < rem; ++q) {
    const long long at = (long long)keep + q;
    if (at < w) cur_src[base + at] = bat_e + rows[open_k + q];
  }
  new_cur_n[p] = keep + rem;
  if (f == 0) {
    for (int j = 0; j < w; ++j) prev_src[base + j] = prev_e + j;
    new_prev_n[p] = prev0;
  } else {
    const int carried_last = f == 1 ? cur0 : 0;
    for (int j = 0; j < w; ++j) prev_src[base + j] = f == 1 && j < cc ? cur_e + j : -1;
    for (int q = plo; q < phi; ++q) {
      const long long at = (long long)carried_last + (q - plo);
      if (at < w) prev_src[base + at] = bat_e + rows[q];
    }
    new_prev_n[p] = carried_last + (phi - plo);
  }
  // the grid, the idle deadline and the next timer
  long long nb = bs, nd = dl, nt = kNoTimer;
  if (a.timed) {
    nb = n_items > 0 && start0 >= 0 ? start0 + open * a.t : start0;
    if (a.timer_mode == kTimerTimeout) {
      const int ncur = keep + rem;
      nd = c > 0 ? now + a.timeout : ncur > 0 ? dl : kNoTimer;
      nt = ncur > 0 ? nd : kNoTimer;
    } else if (a.timer_mode == kTimerBucket) {
      nt = nb >= 0 ? nb + a.t : kNoTimer;
    }
  }
  new_bs[p] = nb;
  new_dl[p] = nd;
  if (nt != kNoTimer) atomicMin(next_timer, nt);
}

// The element i of [open | previous | batch]'s value in a lane.
template <typename T>
__device__ __forceinline__ T pick(const T* cur, const T* prev, const T* bat, int i, int w,
                                  int P) {
  const int pw2 = 2 * P * w;
  if (i >= pw2) return bat[i - pw2];
  const int p = i / (2 * w), j = i % (2 * w);
  return j < w ? cur[p * w + j] : prev[p * w + j - w];
}

__global__ void pb_emit_kernel(const int64_t* batch_ts, const int64_t* cur_ts,
                               const int64_t* prev_ts, const int32_t* slot, int B, int w, int P,
                               int n_out, int stride, int emit, const int32_t* rank,
                               const int32_t* slot_start, const int32_t* n_start,
                               const int32_t* oidx, const int32_t* info,
                               const int32_t* loc_src, const int32_t* loc_row,
                               const int8_t* loc_kind, const int32_t* lbirth,
                               const int32_t* ldeath, int64_t* out_ts, int8_t* out_kind,
                               bool* out_valid, int32_t* out_slot, int32_t* out_first,
                               int32_t* out_src, int32_t* birth, int32_t* death) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int PW2 = 2 * P * w;
  if (k < n_out) {  // item k lands at oidx[k]
    const int R = info[0];
    if (k < R) {
      const int p = slot_of_item(n_start, P, k);
      const int pos = k - n_start[p];
      const int o = oidx[k];
      const long long ls = (long long)p * stride + (emit ? 3 : 2) * (long long)slot_start[p] + pos;
      const int src = loc_src[ls], row = loc_row[ls];
      out_ts[o] = row >= 0 ? batch_ts[row] : pick(cur_ts, prev_ts, batch_ts, src, w, P);
      out_kind[o] = loc_kind[ls];
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
  if (emit && k < PW2 + B) {  // element k: bucket slots, then batch rows
    int p = -1, le = 0;
    if (k < PW2) {
      p = k / (2 * w);
      le = k % (2 * w);
    } else if (rank[k - PW2] >= 0) {
      p = slot[k - PW2];
      le = 2 * w + rank[k - PW2];
    }
    if (p < 0) {
      birth[k] = kBig;
      death[k] = kBig;
    } else {
      const int e = p * 2 * w + slot_start[p] + le;
      const int b = lbirth[e], d = ldeath[e];
      birth[k] = b >= 0 && b != kBig ? oidx[n_start[p] + b] : b;
      death[k] = d >= 0 && d != kBig ? oidx[n_start[p] + d] : d;
    }
  }
}

template <typename T>
__global__ void pb_gather_kernel(const T* cur, const T* prev, const T* bat, const int32_t* idx,
                                 T* out, int n, int w, int P) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const int i = idx[k];
  out[k] = i < 0 ? (T)0 : pick(cur, prev, bat, i, w, P);
}

template <typename T>
int pb_gather(const void* cur, const void* prev, const void* bat, const int32_t* idx, void* out,
              int n, int w, int P, cudaStream_t stream) {
  if (n <= 0) return 0;
  pb_gather_kernel<T><<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      (const T*)cur, (const T*)prev, (const T*)bat, idx, (T*)out, n, w, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// T: the TIMER rows (info[3], read by the caller to size the scratch);
// next_timer must hold NO_TIMER (int64 max) on entry
int pb_step(int B, int w, int P, int n, int timed, int emit, int has_start, int timer_mode,
            long long t, long long start, long long timeout, const int64_t* wts,
            const int32_t* rowlist, const int32_t* slot_start, const int32_t* timers,
            const int32_t* info, const int32_t* cur_n, const int32_t* prev_n,
            const int64_t* bucket_start, const int64_t* deadline, const int64_t* now,
            int32_t* loc_src, int32_t* loc_row, int8_t* loc_kind, int32_t* n_slot,
            int32_t* lbirth, int32_t* ldeath, int32_t* cur_src, int32_t* prev_src,
            int32_t* new_cur_n, int32_t* new_prev_n, int64_t* new_bs, int64_t* new_dl,
            int64_t* next_timer, cudaStream_t stream) {
  Params a{B, w, P, n, timed, emit, has_start, timer_mode, t, start, timeout};
  pb_step_kernel<<<(P + kSlotThreads - 1) / kSlotThreads, kSlotThreads, 0, stream>>>(
      a, wts, rowlist, slot_start, timers, info, cur_n, prev_n, bucket_start, deadline, now,
      loc_src, loc_row, loc_kind, n_slot, lbirth, ldeath, cur_src, prev_src, new_cur_n,
      new_prev_n, new_bs, new_dl, (long long*)next_timer);
  return (int)cudaGetLastError();
}

int pb_place(int P, const int32_t* n_slot, int32_t* n_start, int32_t* pos_base, int32_t* oidx,
             int32_t* counters, int32_t* info, cudaStream_t stream) {
  place_kernel<<<1, kRankThreads, 0, stream>>>(P, n_slot, n_start, pos_base, oidx,
                                                  counters, info);
  return (int)cudaGetLastError();
}

int pb_emit(const int64_t* batch_ts, const int64_t* cur_ts, const int64_t* prev_ts,
            const int32_t* slot, int B, int w, int P, int n_out, int stride, int emit,
            const int32_t* rank, const int32_t* slot_start, const int32_t* n_start,
            const int32_t* oidx, const int32_t* info, const int32_t* loc_src,
            const int32_t* loc_row, const int8_t* loc_kind, const int32_t* lbirth,
            const int32_t* ldeath, int64_t* out_ts, int8_t* out_kind, bool* out_valid,
            int32_t* out_slot, int32_t* out_first, int32_t* out_src, int32_t* birth,
            int32_t* death, cudaStream_t stream) {
  const int n = max(n_out, emit ? 2 * P * w + B : 0);
  pb_emit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      batch_ts, cur_ts, prev_ts, slot, B, w, P, n_out, stride, emit, rank, slot_start,
      n_start, oidx, info, loc_src, loc_row, loc_kind, lbirth, ldeath, out_ts, out_kind,
      out_valid, out_slot, out_first, out_src, birth, death);
  return (int)cudaGetLastError();
}

int pb_gather_1(const void* cur, const void* prev, const void* bat, const int32_t* idx,
                void* out, int n, int w, int P, cudaStream_t stream) {
  return pb_gather<uint8_t>(cur, prev, bat, idx, out, n, w, P, stream);
}
int pb_gather_4(const void* cur, const void* prev, const void* bat, const int32_t* idx,
                void* out, int n, int w, int P, cudaStream_t stream) {
  return pb_gather<uint32_t>(cur, prev, bat, idx, out, n, w, P, stream);
}
int pb_gather_8(const void* cur, const void* prev, const void* bat, const int32_t* idx,
                void* out, int n, int w, int P, cudaStream_t stream) {
  return pb_gather<unsigned long long>(cur, prev, bat, idx, out, n, w, P, stream);
}

}  // extern "C"
