// Tumbling batch window steps for Hopper (sm_90a): lengthBatch (K6) and
// timeBatch / externalTimeBatch (K17), B rows against a [w] open bucket and
// a [w] previous bucket.
//
// Replaces siddhi_tpu/core/windows.py BatchWindow.apply: its lengthBatch
// flush lanes (:553-588), its time branch's (:589-648: start0, the bucket
// index g, carried_g, open_g as a cummax, had_bucket, flush_here, the
// positional timeout_flush, e_row, row_of_flush, new_bucket_start; the open
// bucket's fill :801-806; the idle deadline and next_timer :846-870), and
// the emission both branches share: one multi-operand lax.sort of 3w + 2B +
// F candidates (w + B + F without the EXPIRED lanes), the inverse
// permutation for membership, and compact_set_at for the buffers.
// Here the sort is replaced by per-flush arithmetic. A flush pass finds the
// flushes and writes, per flush f, its trigger row and Q_f, the CURRENT
// batch rows in buckets 0..f; rank/perm of the CURRENT rows; and each
// CURRENT row's bucket (e_row). Two flush passes, each ONE block of 1024
// threads x 32 rows per tile with a carried offset across tiles:
//   - lb_scan (lengthBatch(n), w = n): an exclusive count of the
//     valid-CURRENT rows; with cur_n0 carried rows, n_flush = (cur_n0 + c) /
//     n, Q_f = (f + 1) n - cur_n0, and flush f's trigger is the row that
//     completes bucket f;
//   - tb_scan (time buckets): the first trigger row (for start0), then per
//     tile an exclusive max of g and exclusive counts of trigger and
//     valid-CURRENT rows; a walk that marks each flush (a trigger row
//     entering a later bucket, or an elapsed idle timeout at a TIMER row
//     with no CURRENT row before it: rank == 0); an exclusive count of the
//     flushes. Here the trigger row starts the next bucket.
// Then the shared emission. Flush f emits, in order, the previous bucket's
// E_f EXPIRED rows (prev_n at f = 0, C_{f-1} after; none without the
// EXPIRED lanes) with the trigger row's ts, one RESET row carrying the open
// bucket's first element cur[0], and the bucket's C_f = (f == 0 ? carried :
// 0) + Q_f - Q_{f-1} CURRENT rows (carried rows first at f = 0, then batch
// rows in arrival order):
//   - plan_kernel (one block): S_f, the first output row of flush f, as a
//     scan of E_f + 1 + C_f;
//   - index_kernel: each output row binary-searches its flush and inverts to
//     its source element (carried slot, previous slot or batch row), kind,
//     valid and ts; padding rows are zero, valid false;
//   - elem_kernel: membership stays lazy, birth/death [2w + B] int32 lanes
//     over (carried, previous, batch) elements, never the [rows, 2w + B]
//     matrix of the JAX step (4.7 GB of bools at B = 32768, w = 1024);
//   - state_kernel: a source per slot of the new open and previous buckets,
//     the new counts and, for the time buckets, bucket start, idle deadline
//     and next timer;
//   - bw_gather: every lane and buffer gathered from those sources.
// Any slot past w is a dead lane (a time bucket overflowing its w slots
// drops rows, ops/scatter.py:61); the carried and previous counts are used
// uncapped where the JAX step uses them so. Arithmetic on times wraps as
// int64 does in JAX (a null time is INT64_MIN).
// What bounds it on the card: bytes (B rows + 2w slots in, rows out and
// 2(2w + B) positions: a few MB at B = 32768, microseconds at 3.35 TB/s);
// the single-block scans and the launch count (5 + one gather per lane and
// buffer) dominate at this size. No host sync: the counts, n_flush and the
// new scalars stay in device memory.

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
constexpr long long kNoTimer = LLONG_MAX;
constexpr int8_t kCurrent = 0, kExpired = 1, kTimer = 2, kReset = 3;

int blocks(long long count) { return (int)((count + kThreads - 1) / kThreads); }

__device__ __forceinline__ long long wrap_sub(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

// Exclusive block-wide max of one int64 per thread (LLONG_MIN before the
// first); *total gets the block's max. Same contract as block_excl_sum.
__device__ long long block_excl_max(long long v, long long* ws, long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  long long incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = y > incl ? y : incl;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long x = lane < warps ? ws[lane] : LLONG_MIN;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = y > x ? y : x;
    }
    if (lane < warps) ws[lane] = x;
  }
  __syncthreads();
  long long excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = LLONG_MIN;
  if (warp > 0 && ws[warp - 1] > excl) excl = ws[warp - 1];
  *total = ws[warps - 1];
  __syncthreads();
  return excl;
}

// the step's scalars, written by the flush pass for the emission
struct Scan {
  int c;             // valid CURRENT rows
  int n_flush;       // flushes in the batch
  long long start0;  // the grid's start (-1: no bucket, or lengthBatch)
  long long new_bucket_start;
};

// lengthBatch(n) flush pass: rank/perm/e_row of the valid CURRENT rows, and
// per flush f its trigger (the row completing bucket f) and Q_f.
__global__ void __launch_bounds__(kScanThreads)
lb_scan(const int8_t* kind, const bool* valid, int B, int n, const int32_t* cur_n,
        int32_t* rank, int32_t* perm, int32_t* e_row, int32_t* flush_row, int32_t* flush_q,
        Scan* scan) {
  __shared__ int ws[kScanThreads / 32];
  const int tid = threadIdx.x;
  const long long cur_n0 = *cur_n;
  int carry = 0;
  for (int base = 0; base < B; base += kScanTile) {
    const int start = base + tid * kScanItems;
    unsigned flags = 0;
    int local = 0;
    for (int k = 0; k < kScanItems; ++k) {
      const int r = start + k;
      const bool vc = r < B && valid[r] && kind[r] == kCurrent;
      flags |= (unsigned)vc << k;
      local += vc;
    }
    int tile_total;
    int excl = carry + block_excl_sum(local, ws, &tile_total);
    for (int k = 0; k < kScanItems; ++k) {
      const int r = start + k;
      if (r >= B) break;
      if ((flags >> k) & 1u) {
        rank[r] = excl;
        perm[excl] = r;
        e_row[r] = (int)((cur_n0 + excl) / n);
        ++excl;
      } else {
        rank[r] = -1;
        e_row[r] = 0;
      }
    }
    carry += tile_total;
  }
  __syncthreads();  // perm, written by the whole block, is read below
  const long long n_flush = (cur_n0 + carry) / n;
  for (long long f = tid; f < n_flush; f += kScanThreads) {
    const long long q = (f + 1) * n - cur_n0;
    flush_q[f] = (int)q;
    flush_row[f] = perm[q - 1];
  }
  if (tid == 0) {
    scan->c = carry;
    scan->n_flush = (int)n_flush;
    scan->start0 = -1;
    scan->new_bucket_start = -1;
  }
}

// time-bucket flush pass: as lb_scan, with the flushes found from the
// bucket index of each trigger row and the idle timeout.
__global__ void __launch_bounds__(kScanThreads)
tb_scan(const int8_t* kind, const bool* valid, const int64_t* wts, int B,
        const int32_t* cur_n, const int64_t* bucket_start, const int64_t* deadline,
        const int64_t* now, long long t, int has_start, long long start_time, int has_timeout,
        int32_t* rank, int32_t* perm, int32_t* e_row, int32_t* flush_row, int32_t* flush_q,
        Scan* scan) {
  __shared__ int ws[32];
  __shared__ long long wl[32];
  __shared__ int s_first;
  const int tid = threadIdx.x;
  const long long bs = *bucket_start;
  long long start0;
  if (has_start) {
    start0 = start_time;
  } else {
    // the first trigger row (CURRENT or TIMER)
    if (tid == 0) s_first = B;
    __syncthreads();
    for (int r = tid; r < B; r += kScanThreads) {
      if (valid[r] && (kind[r] == kCurrent || kind[r] == kTimer)) {
        atomicMin(&s_first, r);
        break;
      }
    }
    __syncthreads();
    start0 = bs >= 0 ? bs : (s_first < B ? (long long)wts[s_first] : -1LL);
  }
  const long long carried_g = bs >= 0 ? max(wrap_sub(bs, start0), 0LL) / t : 0LL;
  const bool timeout_armed = has_timeout && *cur_n > 0 && *now >= *deadline;
  long long open = carried_g;  // running max of max(g, carried_g)
  int trig_before = 0, vc_before = 0, flush_before = 0;
  bool any_trig = false;
  for (int base = 0; base < B; base += kScanTile) {
    const int lo = base + tid * kScanItems;
    // pass 1: this thread's rows' max g and counts
    long long gmax = LLONG_MIN;
    int n_trig = 0, n_vc = 0;
    for (int k = 0; k < kScanItems && lo + k < B; ++k) {
      const int r = lo + k;
      const bool vc = valid[r] && kind[r] == kCurrent;
      const bool trig = vc || (valid[r] && kind[r] == kTimer);
      const long long g = trig && start0 >= 0 ? max(wrap_sub(wts[r], start0), 0LL) / t : 0LL;
      gmax = g > gmax ? g : gmax;
      n_trig += trig;
      n_vc += vc;
    }
    long long tile_max;
    int tile_trig, tile_vc, tile_flush;
    const long long excl_max = block_excl_max(gmax, wl, &tile_max);
    const int excl_trig = block_excl_sum(n_trig, ws, &tile_trig);
    const int excl_vc = block_excl_sum(n_vc, ws, &tile_vc);
    // pass 2: mark the flushes
    long long run_open = excl_max > open ? excl_max : open;
    int tb = trig_before + excl_trig, vb = vc_before + excl_vc;
    unsigned flags = 0;
    int n_flush = 0;
    for (int k = 0; k < kScanItems && lo + k < B; ++k) {
      const int r = lo + k;
      const bool vc = valid[r] && kind[r] == kCurrent;
      const bool timer = valid[r] && kind[r] == kTimer;
      const bool trig = vc || timer;
      const long long g = trig && start0 >= 0 ? max(wrap_sub(wts[r], start0), 0LL) / t : 0LL;
      const bool had = bs >= 0 || tb > 0;
      bool flush = trig && g > run_open && had;
      flush = flush || (timer && vb == 0 && timeout_armed);
      flags |= (unsigned)flush << k;
      n_flush += flush;
      run_open = g > run_open ? g : run_open;
      tb += trig;
      vb += vc;
    }
    const int excl_flush = block_excl_sum(n_flush, ws, &tile_flush);
    // pass 3: write the lanes
    int f = flush_before + excl_flush;
    vb = vc_before + excl_vc;
    for (int k = 0; k < kScanItems && lo + k < B; ++k) {
      const int r = lo + k;
      const bool vc = valid[r] && kind[r] == kCurrent;
      if ((flags >> k) & 1u) {
        flush_row[f] = r;
        flush_q[f] = vb;
        ++f;
      }
      if (vc) {
        rank[r] = vb;
        perm[vb] = r;
        e_row[r] = f;  // inclusive: a flush at row r precedes row r
        ++vb;
      } else {
        rank[r] = -1;
        e_row[r] = 0;
      }
    }
    open = tile_max > open ? tile_max : open;
    any_trig = any_trig || tile_trig > 0;
    trig_before += tile_trig;
    vc_before += tile_vc;
    flush_before += tile_flush;
  }
  if (tid == 0) {
    scan->c = vc_before;
    scan->n_flush = flush_before;
    scan->start0 = start0;
    scan->new_bucket_start =
        any_trig && start0 >= 0 ? wrap_add(start0, (long long)((unsigned long long)open * t))
                                : start0;
  }
}

// The step's plan, read by every thread of the emission passes.
struct Plan {
  long long cur_n0, prev_n, cn, pn;  // raw and capped carried / previous counts
  int c, n_flush, w;
  bool exp;
  const int32_t* q;  // flush_q: the CURRENT batch rows in buckets 0..f

  __device__ Plan(const Scan* s, const int32_t* cur_n, const int32_t* prev_n_,
                  const int32_t* flush_q, int w_, bool exp_)
      : cur_n0(*cur_n), prev_n(*prev_n_), c(s->c), n_flush(s->n_flush), w(w_), exp(exp_),
        q(flush_q) {
    cn = cur_n0 < w ? cur_n0 : w;
    pn = prev_n < w ? prev_n : w;
  }
  // first batch rank of bucket b, and its size
  __device__ long long rank0(long long b) const { return b == 0 ? 0 : q[b - 1]; }
  __device__ long long size(long long b) const {
    return (b == 0 ? cn : 0) + q[b] - rank0(b);
  }
  // EXPIRED rows of flush f
  __device__ long long expired(long long f) const {
    return exp ? (f == 0 ? pn : size(f - 1)) : 0;
  }
  // element index of bucket b's i-th element: carried slot, or 2w + batch row
  __device__ int bucket_elem(const int32_t* perm, long long b, long long i) const {
    if (b == 0) return i < cn ? (int)i : 2 * w + perm[i - cn];
    return 2 * w + perm[rank0(b) + i];
  }
};

// S_f = first output row of flush f (S[n_flush] = the rows in all); one block
__global__ void __launch_bounds__(kScanThreads)
plan_kernel(const Scan* scan, const int32_t* cur_n, const int32_t* prev_n,
            const int32_t* flush_q, int w, int exp, int32_t* flush_start) {
  __shared__ int ws[32];
  const Plan pl(scan, cur_n, prev_n, flush_q, w, exp != 0);
  const int F = pl.n_flush;
  int carry = 0;
  for (int base = 0; base < F; base += kScanTile) {
    const int lo = base + threadIdx.x * kScanItems;
    int local = 0;
    for (int k = 0; k < kScanItems && lo + k < F; ++k)
      local += (int)(pl.expired(lo + k) + 1 + pl.size(lo + k));
    int tile_total;
    int run = carry + block_excl_sum(local, ws, &tile_total);
    for (int k = 0; k < kScanItems && lo + k < F; ++k) {
      flush_start[lo + k] = run;
      run += (int)(pl.expired(lo + k) + 1 + pl.size(lo + k));
    }
    carry += tile_total;
  }
  if (threadIdx.x == 0) flush_start[F] = carry;
}

// Per output row p: its source element, kind, ts and valid.
__global__ void index_kernel(const Scan* scan, const int32_t* cur_n, const int32_t* prev_n,
                             const int32_t* flush_q, const int32_t* flush_row,
                             const int32_t* flush_start, const int32_t* perm,
                             const int64_t* batch_ts, const int64_t* cur_ts, int w, int rows,
                             int exp, int32_t* out_src, int64_t* out_ts, int8_t* out_kind,
                             bool* out_valid) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= rows) return;
  const Plan pl(scan, cur_n, prev_n, flush_q, w, exp != 0);
  int src = -1;
  int8_t kind = 0;
  long long ts = 0;
  if (p < flush_start[pl.n_flush]) {
    int lo = 0, hi = pl.n_flush - 1;  // the last f with S_f <= p
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (flush_start[mid] <= p)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int f = lo;
    const long long o = p - flush_start[f];
    const long long e = pl.expired(f);
    if (o < e) {  // EXPIRED: the bucket closed at flush f - 1 (or the previous one)
      kind = kExpired;
      src = f == 0 ? w + (int)o : pl.bucket_elem(perm, f - 1, o);
      ts = batch_ts[flush_row[f]];
    } else if (o == e) {  // RESET, carrying the open bucket's first slot
      kind = kReset;
      src = 0;
      ts = cur_ts[0];
    } else {
      kind = kCurrent;
      src = pl.bucket_elem(perm, f, o - e - 1);
      ts = src < w ? cur_ts[src] : batch_ts[src - 2 * w];
    }
  }
  out_src[p] = src;
  out_ts[p] = ts;
  out_kind[p] = kind;
  out_valid[p] = src >= 0;
}

// Per element e of [carried w | previous w | batch B]: the output rows
// birth <= p < death in which it is a member.
__global__ void elem_kernel(const Scan* scan, const int32_t* cur_n, const int32_t* prev_n,
                            const int32_t* flush_q, const int32_t* flush_start,
                            const int32_t* rank, const int32_t* e_row, int B, int w,
                            int32_t* birth, int32_t* death) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 2 * w + B) return;
  const Plan pl(scan, cur_n, prev_n, flush_q, w, true);
  long long b = kBig, d = kBig;
  if (e < w) {
    if (e < pl.cn && pl.n_flush >= 1) b = flush_start[0] + pl.expired(0) + 1 + e;
    if (e < pl.cn && pl.n_flush > 1) d = flush_start[1] + e;
  } else if (e < 2 * w) {
    d = -1;
  } else {
    const int r = e - 2 * w;
    const int rk = rank[r];
    if (rk >= 0) {
      const long long bk = e_row[r];
      if (bk < pl.n_flush) {
        const long long i = bk == 0 ? pl.cn + rk : rk - pl.rank0(bk);
        b = flush_start[bk] + pl.expired(bk) + 1 + i;
        if (bk + 1 < pl.n_flush) d = flush_start[bk + 1] + i;
      }
    }
  }
  birth[e] = (int)b;
  death[e] = (int)d;
}

// Per buffer slot j: where the new open and previous buckets' contents come
// from (-1 = zero), and the new counts; for the time buckets (non-null
// new_bucket_start) also the bucket start, idle deadline and next timer.
__global__ void state_kernel(const Scan* scan, const int32_t* cur_n, const int32_t* prev_n,
                             const int32_t* flush_q, const int32_t* perm,
                             const int64_t* deadline, const int64_t* now, int w, long long t,
                             int timer_mode, long long timeout, int32_t* cur_src,
                             int32_t* prev_src, int32_t* new_cur_n, int32_t* new_prev_n,
                             int64_t* new_bucket_start, int64_t* new_deadline,
                             int64_t* next_timer) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const Plan pl(scan, cur_n, prev_n, flush_q, w, true);
  const int F = pl.n_flush;
  const long long rem = F == 0 ? pl.c : pl.c - pl.q[F - 1];  // rows left open
  if (j < w) {
    if (F == 0) {
      cur_src[j] = (j >= pl.cur_n0 && j < pl.cur_n0 + pl.c) ? 2 * w + perm[j - pl.cur_n0] : j;
      prev_src[j] = w + j;
    } else {
      cur_src[j] = j < rem ? 2 * w + perm[pl.q[F - 1] + j] : -1;
      const long long lead = F == 1 ? pl.cur_n0 : 0;  // carried rows in the last bucket
      const long long last_n = pl.q[F - 1] - pl.rank0(F - 1);
      if (F == 1 && j < pl.cn)
        prev_src[j] = j;
      else if (j >= lead && j - lead < last_n)
        prev_src[j] = 2 * w + perm[pl.rank0(F - 1) + j - lead];
      else
        prev_src[j] = -1;
    }
  }
  if (j == 0) {
    const long long ncur = F == 0 ? pl.cur_n0 + pl.c : rem;
    *new_cur_n = (int32_t)ncur;
    *new_prev_n = (int32_t)(F == 0 ? pl.prev_n
                                   : (F == 1 ? pl.cur_n0 : 0) + pl.q[F - 1] - pl.rank0(F - 1));
    if (new_bucket_start == nullptr) return;
    const long long nbs = scan->new_bucket_start;
    *new_bucket_start = nbs;
    if (timer_mode == 2) {  // externalTimeBatch idle timeout (wall clock)
      const long long dl = pl.c > 0 ? wrap_add(*now, timeout) : (ncur > 0 ? *deadline : kNoTimer);
      *new_deadline = dl;
      *next_timer = ncur > 0 ? dl : kNoTimer;
    } else {
      *new_deadline = *deadline;
      *next_timer = timer_mode == 1 && nbs >= 0 ? wrap_add(nbs, t) : kNoTimer;
    }
  }
}

// The emission after either flush pass. The time-bucket scalars (deadline,
// now, new_bucket_start, new_deadline, next_timer) are null for lengthBatch.
int emit(const Scan* sc, const int32_t* cur_n, const int32_t* prev_n, const int32_t* flush_q,
         const int32_t* flush_row, int32_t* flush_start, const int32_t* rank,
         const int32_t* perm, const int32_t* e_row, const int64_t* batch_ts,
         const int64_t* cur_ts, const int64_t* deadline, const int64_t* now, int B, int w,
         int rows, int exp, long long t, int timer_mode, long long timeout, int32_t* out_src,
         int64_t* out_ts, int8_t* out_kind, bool* out_valid, int32_t* birth, int32_t* death,
         int32_t* cur_src, int32_t* prev_src, int32_t* new_cur_n, int32_t* new_prev_n,
         int64_t* new_bucket_start, int64_t* new_deadline, int64_t* next_timer,
         cudaStream_t stream) {
  plan_kernel<<<1, kScanThreads, 0, stream>>>(sc, cur_n, prev_n, flush_q, w, exp, flush_start);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  index_kernel<<<blocks(rows), kThreads, 0, stream>>>(sc, cur_n, prev_n, flush_q, flush_row,
                                                      flush_start, perm, batch_ts, cur_ts, w,
                                                      rows, exp, out_src, out_ts, out_kind,
                                                      out_valid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (exp) {
    elem_kernel<<<blocks(2LL * w + B), kThreads, 0, stream>>>(sc, cur_n, prev_n, flush_q,
                                                              flush_start, rank, e_row, B, w,
                                                              birth, death);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  state_kernel<<<blocks(w), kThreads, 0, stream>>>(sc, cur_n, prev_n, flush_q, perm, deadline,
                                                   now, w, t, timer_mode, timeout, cur_src,
                                                   prev_src, new_cur_n, new_prev_n,
                                                   new_bucket_start, new_deadline, next_timer);
  return (int)cudaGetLastError();
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
  gather_kernel<T><<<blocks(count), kThreads, 0, stream>>>(
      (const T*)cur, (const T*)prev, (const T*)batch, idx, (T*)out, count, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lengthBatch(n): w = n. Scratch: rank, perm, e_row, flush_row, flush_q [B]
// int32, flush_start [B + 1] int32, scan (24 bytes, 8-byte aligned).
int bw_prepare(const int8_t* kind, const bool* valid, const int64_t* batch_ts,
               const int64_t* cur_ts, const int32_t* cur_n, const int32_t* prev_n, int B, int n,
               int rows, int exp, int32_t* rank, int32_t* perm, int32_t* e_row,
               int32_t* flush_row, int32_t* flush_q, int32_t* flush_start, void* scan,
               int32_t* out_src, int64_t* out_ts, int8_t* out_kind, bool* out_valid,
               int32_t* birth, int32_t* death, int32_t* cur_src, int32_t* prev_src,
               int32_t* new_cur_n, int32_t* new_prev_n, cudaStream_t stream) {
  Scan* sc = (Scan*)scan;
  lb_scan<<<1, kScanThreads, 0, stream>>>(kind, valid, B, n, cur_n, rank, perm, e_row,
                                          flush_row, flush_q, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return emit(sc, cur_n, prev_n, flush_q, flush_row, flush_start, rank, perm, e_row, batch_ts,
              cur_ts, nullptr, nullptr, B, n, rows, exp, 1, 0, 0, out_src, out_ts, out_kind,
              out_valid, birth, death, cur_src, prev_src, new_cur_n, new_prev_n, nullptr,
              nullptr, nullptr, stream);
}

// Time buckets. timer_mode: 0 none, 1 bucket end (timeBatch), 2 idle
// timeout (externalTimeBatch with a timeout). Scratch as bw_prepare's.
int tb_prepare(const int8_t* kind, const bool* valid, const int64_t* batch_ts,
               const int64_t* wts, const int64_t* cur_ts, const int32_t* cur_n,
               const int32_t* prev_n, const int64_t* bucket_start, const int64_t* deadline,
               const int64_t* now, int B, int w, int rows, int exp, long long t,
               int has_start, long long start_time, int timer_mode, long long timeout,
               int32_t* rank, int32_t* perm, int32_t* e_row, int32_t* flush_row,
               int32_t* flush_q, int32_t* flush_start, void* scan, int32_t* out_src,
               int64_t* out_ts, int8_t* out_kind, bool* out_valid, int32_t* birth,
               int32_t* death, int32_t* cur_src, int32_t* prev_src, int32_t* new_cur_n,
               int32_t* new_prev_n, int64_t* new_bucket_start, int64_t* new_deadline,
               int64_t* next_timer, cudaStream_t stream) {
  Scan* sc = (Scan*)scan;
  tb_scan<<<1, kScanThreads, 0, stream>>>(kind, valid, wts, B, cur_n, bucket_start, deadline,
                                          now, t, has_start, start_time, timer_mode == 2,
                                          rank, perm, e_row, flush_row, flush_q, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return emit(sc, cur_n, prev_n, flush_q, flush_row, flush_start, rank, perm, e_row, batch_ts,
              cur_ts, deadline, now, B, w, rows, exp, t, timer_mode, timeout, out_src, out_ts,
              out_kind, out_valid, birth, death, cur_src, prev_src, new_cur_n, new_prev_n,
              new_bucket_start, new_deadline, next_timer, stream);
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
