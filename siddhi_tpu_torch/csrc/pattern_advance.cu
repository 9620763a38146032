// Token-matrix slot pass of the pattern engine for Hopper (sm_90a): one NFA
// slot over a chunk of C rows, for every token of the T-lane token table.
//
// Replaces the per-slot body of siddhi_tpu/core/pattern.py
// PatternProgram.apply_batch_fast (:1774-1862) and the tail slots of
// apply_batch_count (:1647-1685): the [T, C] match matrix
// M = elig & v & (row > entry_row) & cond & within-ok, sequence strictness
// (the match must be the first valid row after the entry, a miss kills the
// token), then either
//   - advance: each eligible token moves to its FIRST matching row, writing
//     slot, start_ts (the fast route only), entry_ts, entry_row, the ref's
//     occurrence count and the column-0 captures gathered from that row; or
//   - the `every` fork at slot 0: every row that some eligible token matches
//     forks a new token into the rank-th free lane (free lanes counted over
//     the whole [T] ~active mask, ranks over the chunk's rows); forks past
//     the free lanes are dropped and raise the overflow flag.
// Neither M nor cond & ... is materialised: the condition comes as a strided
// [T, C] bool view (stride 0 along T for a row-only condition, so it costs C
// bytes), and each token stops at its first hit.
// Design: advance runs one warp per token, 32 rows a step with a ballot; the
// fork runs in one block, which lists the eligible tokens and the free lanes
// with block scans and ranks the forking rows with a carried block scan.
// The capture lanes are rebuilt by common.cuh's gather_lanes through the
// per-token source row (-1: unchanged).
// What bounds it on the card: bytes, the [T] token lanes and C row lanes
// read and written once (about 0.2 MB at T = 4096, C = 2048); the launches
// and the single fork block dominate at these sizes.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Rows {
  const bool* v;        // [C] valid CURRENT rows
  const int64_t* ts;    // [C] row timestamps
  const bool* cond;     // strided [T, C] condition
  long long cst, csc;   // its strides along T and along C (elements)
  int C;
  int has_win;
  long long win;        // within bound (ms) when has_win
};

// Row j satisfies token t's condition and within bound (v and the entry
// row are the caller's).
__device__ __forceinline__ bool cond_ok(const Rows& R, int t, int j, int64_t start) {
  if (!R.cond[t * R.cst + j * R.csc]) return false;
  return !(R.has_win && start >= 0 && R.ts[j] - start > R.win);
}

__global__ void advance_kernel(const bool* active, const int32_t* slot, const int64_t* start_ts,
                               const int64_t* entry_ts, const int32_t* entry_row,
                               const int32_t* n_in, Rows R, int T, int p, int strict,
                               int set_start, bool* active_o, int32_t* slot_o, int64_t* start_o,
                               int64_t* entry_ts_o, int32_t* entry_row_o, int32_t* n_o,
                               int32_t* src, const bool* ovf_in, bool* ovf_o) {
  if (blockIdx.x == 0 && threadIdx.x == 0) *ovf_o = *ovf_in;  // an advance never overflows
  const int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= T) return;
  const bool act = active[t];
  const int32_t s = slot[t];
  const int64_t st = start_ts[t];
  const int32_t er = entry_row[t];
  int hit = -1;
  bool die = false;
  if (act && s == p) {
    for (int j0 = er + 1; j0 < R.C; j0 += 32) {
      const int j = j0 + lane;
      if (strict) {
        const unsigned m = __ballot_sync(kFull, j < R.C && R.v[j]);
        if (m) {
          const int jn = j0 + __ffs(m) - 1;  // the first valid row after the entry
          if (cond_ok(R, t, jn, st)) hit = jn;
          else die = true;
          break;
        }
      } else {
        const unsigned m = __ballot_sync(kFull, j < R.C && R.v[j] && cond_ok(R, t, j, st));
        if (m) {
          hit = j0 + __ffs(m) - 1;
          break;
        }
      }
    }
  }
  if (lane != 0) return;
  active_o[t] = act && !die;
  if (hit >= 0) {
    const int64_t mts = R.ts[hit];
    slot_o[t] = p + 1;
    start_o[t] = set_start && st < 0 ? mts : st;
    entry_ts_o[t] = mts;
    entry_row_o[t] = hit;
    n_o[t] = 1;
    src[t] = hit;
  } else {
    slot_o[t] = s;
    start_o[t] = st;
    entry_ts_o[t] = entry_ts[t];
    entry_row_o[t] = er;
    n_o[t] = n_in[t];
    src[t] = -1;
  }
}

__global__ void __launch_bounds__(kBlock, 1)
fork_kernel(const bool* active, const int32_t* slot, const int64_t* start_ts,
            const int64_t* entry_ts, const int32_t* entry_row, const int32_t* n_in, Rows R, int T,
            int p, bool* active_o, int32_t* slot_o, int64_t* start_o, int64_t* entry_ts_o,
            int32_t* entry_row_o, int32_t* n_o, int32_t* src, int32_t* etok, int32_t* free_idx,
            const bool* ovf_in, bool* ovf_o) {
  __shared__ int ws[32];
  const int tid = threadIdx.x;
  // 1. copy the token lanes through; list the eligible tokens and the free
  //    lanes, both in lane order
  int ne = 0, nfree = 0;
  for (int base = 0; base < T; base += kBlock) {
    const int t = base + tid;
    bool e = false, f = false;
    if (t < T) {
      const bool a = active[t];
      e = a && slot[t] == p;
      f = !a;
      active_o[t] = a;
      slot_o[t] = slot[t];
      start_o[t] = start_ts[t];
      entry_ts_o[t] = entry_ts[t];
      entry_row_o[t] = entry_row[t];
      n_o[t] = n_in[t];
      src[t] = -1;
    }
    int te, tf;
    const int xe = block_excl_sum(e, ws, &te);
    const int xf = block_excl_sum(f, ws, &tf);
    if (e) etok[ne + xe] = t;
    if (f) free_idx[nfree + xf] = t;
    ne += te;
    nfree += tf;
  }
  __syncthreads();
  // 2. each forking row takes the free lane of its rank among the forks
  int carry = 0;
  bool over = false;
  for (int base = 0; base < R.C; base += kBlock) {
    const int j = base + tid;
    bool fk = false;
    if (j < R.C && R.v[j]) {
      for (int k = 0; k < ne && !fk; ++k) {
        const int e = etok[k];
        fk = j > entry_row[e] && cond_ok(R, e, j, start_ts[e]);
      }
    }
    int total;
    const int r = carry + block_excl_sum(fk, ws, &total);
    if (fk) {
      if (r < nfree) {
        const int d = free_idx[r];
        active_o[d] = true;
        slot_o[d] = p + 1;
        start_o[d] = R.ts[j];
        entry_ts_o[d] = R.ts[j];
        entry_row_o[d] = j;
        n_o[d] = 1;
        src[d] = j;
      } else {
        over = true;
      }
    }
    carry += total;
  }
  over = __syncthreads_or(over);
  if (tid == 0) *ovf_o = *ovf_in || over;
}

}  // namespace

extern "C" {

// One slot pass. In: the token lanes, the ref's count n_in, the chunk's
// rows and the strided condition. Out: fresh token lanes, src [T] (the row
// each token's column-0 captures come from, -1: unchanged), the overflow
// flag ovf_o = ovf_in | (a fork found no free lane), and the ref's capture
// lanes (old [T] -> out [T], gathered from the row lanes srcv by src).
// scratch: int32 [2T] (fork only).
int pa_step(const bool* active, const int32_t* slot, const int64_t* start_ts,
            const int64_t* entry_ts, const int32_t* entry_row, const int32_t* n_in,
            const bool* v, const int64_t* batch_ts, const bool* cond, long long cst,
            long long csc, int T, int C, int p, int fork, int strict, int set_start, int has_win,
            long long win, bool* active_o, int32_t* slot_o, int64_t* start_o,
            int64_t* entry_ts_o, int32_t* entry_row_o, int32_t* n_o, int32_t* src,
            int32_t* scratch, const bool* ovf_in, bool* ovf_o, int n_lanes,
            const void* const* old, const void* const* srcv, void* const* out, const int* size,
            cudaStream_t stream) {
  const Rows R{v, batch_ts, cond, cst, csc, C, has_win, win};
  if (fork) {
    fork_kernel<<<1, kBlock, 0, stream>>>(active, slot, start_ts, entry_ts, entry_row, n_in, R, T,
                                          p, active_o, slot_o, start_o, entry_ts_o, entry_row_o,
                                          n_o, src, scratch, scratch + T, ovf_in, ovf_o);
  } else {
    advance_kernel<<<(T + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
        active, slot, start_ts, entry_ts, entry_row, n_in, R, T, p, strict, set_start, active_o,
        slot_o, start_o, entry_ts_o, entry_row_o, n_o, src, ovf_in, ovf_o);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_lanes > 0) {
    const int32_t* idx[kMaxGatherLanes];
    long long nulls[kMaxGatherLanes];
    int width[kMaxGatherLanes], per_elem[kMaxGatherLanes];
    for (int base = 0; base < n_lanes; base += kMaxGatherLanes) {
      const int k = n_lanes - base < kMaxGatherLanes ? n_lanes - base : kMaxGatherLanes;
      for (int i = 0; i < k; ++i) {
        idx[i] = src;
        nulls[i] = 0;
        width[i] = 1;
        per_elem[i] = 0;
      }
      const int e = gather_lanes(k, old + base, srcv + base, out + base, idx, nulls, size + base,
                                 width, per_elem, T, stream);
      if (e != 0) return e;
    }
  }
  return 0;
}

}  // extern "C"
