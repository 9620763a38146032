// Closed-form count pass of the pattern engine for Hopper (sm_90a): slots 0
// and 1 of `every? A<m:n> -> B -> ...` over a chunk of C rows, with the
// `every` generation chain.
//
// Replaces siddhi_tpu/core/pattern.py PatternProgram.apply_batch_count
// :1406-1645: the rank of slot 0's matches (midx_excl, k_total, the match
// rows mrow), the suffix-min of slot 1's advance rows (madv_next), per
// token the searchsorted (side="left") of its count threshold into the
// non-decreasing midx_excl, the absorption span A and the [T, K] capture
// writes masked by src < A, n += A, start_ts, slot 1's capture and advance;
// then the generation chain: s_g, valid_g, the same searchsorted for each
// generation's advance row, Ag, the rank into free lanes, and both overflow
// rules (the chain cap Gmax = min(C // m + 1, T) and lane exhaustion).
// Design: one block scans the chunk (counts, compaction, the reverse
// min-scan), reduces the youngest pending token, lists the free lanes and
// resolves every generation (each a binary search) into its lane; then one
// thread per token writes the token lanes and the index maps by which
// common.cuh's gather_lanes rebuilds the capture lanes (row >= 0: the
// event's value, -1: unchanged, -2: null).
// What bounds it on the card: bytes, the C row lanes and the [T] / [T, K]
// token lanes read and written once (about 0.2 MB at C = 8192, T = 512,
// K = 4); the single scan block dominates.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;
constexpr int kThreads = 256;

struct Chunk {
  const int64_t* ts;  // [C]
  const int32_t* midx;       // [C] exclusive match rank
  const int32_t* mrow;       // [C] k-th match row, C past the last
  const int32_t* madv_next;  // [C] first advance row at or after b, C if none
  int C;
};

// First b with midx[b] >= x (searchsorted side="left"), C if none.
__device__ __forceinline__ int lower_bound(const int32_t* midx, int C, long long x) {
  int lo = 0, hi = C;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (midx[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int clampi(long long x, int lo, int hi) {
  return x < lo ? lo : x > hi ? hi : (int)x;
}

// mrow clipped to a row, at a clipped rank: JAX's mrow_c[clip(k, 0, C-1)]
__device__ __forceinline__ int match_row(const Chunk& K, long long k) {
  const int r = K.mrow[clampi(k, 0, K.C - 1)];
  return r < K.C - 1 ? r : K.C - 1;
}

// scal: [0] k_total, [1] youngest pending count ny, [2] tail exists
__global__ void __launch_bounds__(kBlock, 1)
scan_kernel(const bool* Mc, const bool* Madv, const bool* active, const int32_t* slot,
            const int32_t* n0, int T, int C, int m, int Mmax, int persistent, int Gmax,
            int32_t* midx, int32_t* mrow, int32_t* madv_next, int32_t* free_idx, int32_t* gen_of,
            int32_t* gA, int32_t* gj, int32_t* scal, const bool* ovf_in, bool* ovf_o) {
  __shared__ int ws[32];
  const int tid = threadIdx.x;
  // slot 0's match ranks and rows
  int k_total = 0;
  for (int base = 0; base < C; base += kBlock) {
    const int j = base + tid;
    const bool mc = j < C && Mc[j];
    int total;
    const int x = k_total + block_excl_sum(mc, ws, &total);
    if (j < C) midx[j] = x;
    if (mc) mrow[x] = j;
    k_total += total;
  }
  for (int k = k_total + tid; k < C; k += kBlock) mrow[k] = C;
  // slot 1's next advance row, a min-scan from the end
  int carry = C;
  for (int end = C; end > 0; end -= kBlock) {
    const int j = end - 1 - tid;
    int tmin;
    const int incl = block_incl_min(j >= 0 && Madv[j] ? j : C, ws, &tmin);
    if (j >= 0) madv_next[j] = incl < carry ? incl : carry;
    carry = tmin < carry ? tmin : carry;
  }
  // the youngest pending token below min, the free lanes
  int ny = m, nfree = 0;
  bool tail = false;
  for (int base = 0; base < T; base += kBlock) {
    const int t = base + tid;
    bool f = false;
    int tn = m;
    if (t < T) {
      const bool a = active[t];
      f = !a;
      if (a && slot[t] == 0 && n0[t] < m) {
        tail = true;
        tn = n0[t];
      }
      gen_of[t] = -1;
    }
    int tmin;
    block_incl_min(tn, ws, &tmin);
    ny = tmin < ny ? tmin : ny;
    int total;
    const int x = block_excl_sum(f, ws, &total);
    if (f && nfree + x < Gmax) free_idx[nfree + x] = t;
    nfree += total;
  }
  tail = __syncthreads_or(tail);
  bool over = false;
  if (persistent) {
    // generation g arms at the (m - ny + g*m)-th match; it advances at the
    // first advance row whose rank reaches s_g + m
    over = tail && (long long)(m - ny) + (long long)Gmax * m <= k_total;
    for (int g = tid; g < Gmax; g += kBlock) {
      const long long s = (long long)(m - ny) + (long long)g * m;
      if (!(tail && s <= k_total)) continue;
      const int b0 = lower_bound(midx, C, s + m);
      const int jrow = b0 < C ? madv_next[b0] : C;
      const bool has = jrow < C;
      const long long reach = has ? midx[jrow] : k_total;
      long long A = reach - s;
      A = A < 0 ? 0 : A > Mmax ? Mmax : A;
      if (g < nfree) {
        gen_of[free_idx[g]] = g;
        gA[g] = (int)A;
        gj[g] = has ? jrow : -1;
      } else {
        over = true;
      }
    }
  }
  over = __syncthreads_or(over);
  if (tid == 0) {
    scal[0] = k_total;
    scal[1] = ny;
    scal[2] = tail;
    *ovf_o = *ovf_in || over;
  }
}

__global__ void token_kernel(Chunk K, const bool* active, const int32_t* slot,
                             const int64_t* start_ts, const int64_t* entry_ts, const int32_t* n0,
                             const int32_t* n1, int T, int Kcap, int m, int Mmax, int has_ev1,
                             const int32_t* gen_of, const int32_t* gA, const int32_t* gj,
                             const int32_t* scal, bool* active_o, int32_t* slot_o,
                             int64_t* start_o, int64_t* entry_ts_o, int32_t* entry_row_o,
                             int32_t* n0_o, int32_t* n1_o, int32_t* idx0, int32_t* idx1,
                             int32_t* idxo) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const int k_total = scal[0], ny = scal[1];
  const int g = gen_of[t];
  int32_t* q0 = idx0 + (long long)t * Kcap;
  if (g >= 0) {  // a fresh generation token in a free lane
    const long long s = (long long)(m - ny) + (long long)g * m;
    const int A = gA[g], jrow = gj[g];
    const bool has = jrow >= 0;
    active_o[t] = true;
    slot_o[t] = has ? 2 : 0;
    start_o[t] = A > 0 ? K.ts[match_row(K, s)] : -1;
    entry_ts_o[t] = K.ts[match_row(K, s - 1)];
    entry_row_o[t] = has ? jrow : -1;
    n0_o[t] = A;
    for (int q = 0; q < Kcap; ++q) q0[q] = q < A ? match_row(K, s + q) : -2;
    if (has_ev1) {
      n1_o[t] = has;
      idx1[t] = has ? jrow : -2;
    }
    idxo[t] = -2;
    return;
  }
  const bool a = active[t];
  const int n = n0[t];
  active_o[t] = a;
  idxo[t] = -1;
  if (!(a && slot[t] == 0)) {
    slot_o[t] = slot[t];
    start_o[t] = start_ts[t];
    entry_ts_o[t] = entry_ts[t];
    entry_row_o[t] = -1;
    n0_o[t] = n;
    for (int q = 0; q < Kcap; ++q) q0[q] = -1;
    if (has_ev1) {
      n1_o[t] = n1[t];
      idx1[t] = -1;
    }
    return;
  }
  // a token at slot 0: absorb every match up to its advance row
  const int thresh = m - clampi(n, 0, m);
  const int room = Mmax - clampi(n, 0, Mmax);
  const int b0 = lower_bound(K.midx, K.C, thresh);
  const int jt = b0 < K.C ? K.madv_next[b0] : K.C;
  const bool has = jt < K.C;
  const int jc = has ? jt : K.C - 1;
  int A = has ? K.midx[jc] : k_total;
  A = A < 0 ? 0 : A > room ? room : A;
  n0_o[t] = n + A;
  for (int q = 0; q < Kcap; ++q) {
    const int src = q - n;
    q0[q] = src >= 0 && src < A ? match_row(K, src) : -1;
  }
  const int64_t st = start_ts[t];
  start_o[t] = st < 0 && A > 0 ? K.ts[match_row(K, 0)] : st;
  slot_o[t] = has ? 2 : 0;
  entry_ts_o[t] = has ? K.ts[jc] : entry_ts[t];
  entry_row_o[t] = has ? jt : -1;
  if (has_ev1) {
    n1_o[t] = has ? 1 : n1[t];
    idx1[t] = has ? jt : -1;
  }
}

}  // namespace

extern "C" {

// One chunk's count pass. In: the row masks Mc (slot 0's condition) and
// Madv (slot 1's), the token lanes, slot 0's and slot 1's counts. Out:
// fresh token lanes, entry_row, both counts, ovf_o = ovf_in | overflow,
// and the capture lanes rebuilt through the index maps (lane l: old ->
// out from srcv by idx0 [T, K] per element, idx1 [T] or idxo [T] per row;
// which map is lane_map[l]: 0, 1 or 2). scratch: int32 [3C + (K + 7)T + 3].
int pc_step(const bool* Mc, const bool* Madv, const int64_t* batch_ts, const bool* active,
            const int32_t* slot, const int64_t* start_ts, const int64_t* entry_ts,
            const int32_t* n0, const int32_t* n1, int T, int C, int Kcap, int m, int Mmax,
            int persistent, int has_ev1, int Gmax, bool* active_o, int32_t* slot_o,
            int64_t* start_o, int64_t* entry_ts_o, int32_t* entry_row_o, int32_t* n0_o,
            int32_t* n1_o, int32_t* scratch, const bool* ovf_in, bool* ovf_o, int n_lanes,
            const void* const* old, const void* const* srcv, void* const* out, const int* size,
            const int* width, const int* lane_map, const long long* null_bits,
            cudaStream_t stream) {
  int32_t* midx = scratch;
  int32_t* mrow = midx + C;
  int32_t* madv_next = mrow + C;
  int32_t* idx0 = madv_next + C;  // [T * Kcap]
  int32_t* idx1 = idx0 + (long long)T * Kcap;
  int32_t* idxo = idx1 + T;
  int32_t* free_idx = idxo + T;
  int32_t* gen_of = free_idx + T;
  int32_t* gA = gen_of + T;
  int32_t* gj = gA + T;
  int32_t* scal = gj + T;
  scan_kernel<<<1, kBlock, 0, stream>>>(Mc, Madv, active, slot, n0, T, C, m, Mmax, persistent,
                                        Gmax, midx, mrow, madv_next, free_idx, gen_of, gA, gj,
                                        scal, ovf_in, ovf_o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Chunk K{batch_ts, midx, mrow, madv_next, C};
  token_kernel<<<(T + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      K, active, slot, start_ts, entry_ts, n0, n1, T, Kcap, m, Mmax, has_ev1, gen_of, gA, gj,
      scal, active_o, slot_o, start_o, entry_ts_o, entry_row_o, n0_o, n1_o, idx0, idx1, idxo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_lanes <= 0) return 0;
  const int32_t* maps[3] = {idx0, idx1, idxo};
  const int32_t* idx[kMaxGatherLanes];
  int per_elem[kMaxGatherLanes];
  for (int base = 0; base < n_lanes; base += kMaxGatherLanes) {
    const int k = n_lanes - base < kMaxGatherLanes ? n_lanes - base : kMaxGatherLanes;
    for (int i = 0; i < k; ++i) {
      idx[i] = maps[lane_map[base + i]];
      per_elem[i] = lane_map[base + i] == 0;
    }
    const int e = gather_lanes(k, old + base, srcv + base, out + base, idx, null_bits + base,
                               size + base, width + base, per_elem, T, stream);
    if (e != 0) return e;
  }
  return 0;
}

}  // extern "C"
