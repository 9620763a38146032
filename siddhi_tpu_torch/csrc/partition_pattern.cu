// The pattern engine's batch routes keyed by partition slot, for Hopper
// (sm_90a): K34 (one NFA slot's pass), K35 (the closed-form count pass)
// and K36 (the completions and the within purge) over one chunk of a batch
// whose rows each carry their partition slot, with the chunks' row lists
// and the (position, slot) placement of the emissions.
//
// Replaces siddhi_tpu/core/partition.py
// PartitionedPatternQueryRuntime._pstep_impl (:326-376), the jax.vmap over
// P partition lanes of the pattern step, for its two batch routes
// (siddhi_tpu/core/pattern_runtime.py fast_step :173-224): each lane runs
// PatternProgram.apply_batch_fast (K34 :1774-1862 a slot, K36
// :1864-1912) or apply_batch_count (K35 :1406-1645, K34 on the tail slots
// :1647-1685, K36 :1687-1725) on chunk i of the whole batch, rows
// [iC, (i+1)C), with only its own rows valid; then `_flatten` (:436) orders
// the [P, out_cap] emissions by position first and lane second.
//
// Design: a chunk's member rows are listed once a step by (slot, row) with
// their (slot, rows) segments (`pp_chunks`, one block a chunk, the
// counting ranks of partition.cuh). Each keyed launch runs chunk i with one
// block a segment: the block works on its slot's [T] lanes of the [P*T]
// token table, in place, and on the segment's rows only, at their
// chunk-local positions, so a chunk costs O(its rows + T a slot with rows)
// and never O(P * C). K34's advance gives each token a thread, which walks
// the slot's rows for the first match (sequence strictness: the first row
// after the entry decides); the `every` fork lists the slot's eligible
// tokens and free lanes with block scans and ranks the forking rows with a
// carried block scan (forks past the slot's free lanes raise the flag and
// leave the other slots untouched). K35 compacts the segment's rows: the
// match ranks, the match list and the next advance row (a reverse min
// scan) over the segment replace the [C] lanes of K14, and each lookup of
// K14 (searchsorted into the match ranks, then the next advance row) maps
// to "the first advance row after the thresh-th match"; the chain cap
// Gmax = min(C // m + 1, T) keeps the whole chunk's C. K36 lists the
// slot's done tokens, ranks them by (completion row, lane), appends them
// to the slot's stretch of the emission lanes and purges. The placement
// (`pp_place`) is partition.cuh's; a gather then copies each lane.
// What bounds it on the card: launches. Each launch touches a few bytes a
// row and the [T] lanes of each slot with rows in the chunk (tens of KB at
// T = 128), far below a microsecond of memory time; a step launches
// (slots + 1) kernels a chunk.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "partition.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 24;

// capture lanes a keyed kernel writes: lane l is [P*T, width] (or, for
// K36's destinations, [E, width]); src the row column [rows] it copies
// from (K34/K35) or the token lane (K36)
struct Lanes {
  void* lane[kMaxL];
  const void* src[kMaxL];
  int size[kMaxL];
  int width[kMaxL];
  int map[kMaxL];
  long long null_bits[kMaxL];
  int n;
};

struct Seg {
  const int32_t* srow;  // [k*C] member rows by (slot, row), chunk i at i*C
  const int32_t* slot;  // [k*C] segment s of chunk i at i*C + s: its slot
  const int32_t* lo;    // and its rows srow[lo:hi] (absolute)
  const int32_t* hi;
  const int32_t* nseg;  // [k]
};

__device__ __forceinline__ unsigned long long ld(const void* b, long long i, int size) {
  switch (size) {
    case 1: return ((const uint8_t*)b)[i];
    case 4: return ((const uint32_t*)b)[i];
    default: return ((const unsigned long long*)b)[i];
  }
}
__device__ __forceinline__ void st(void* b, long long i, int size, unsigned long long v) {
  switch (size) {
    case 1: ((uint8_t*)b)[i] = (uint8_t)v; break;
    case 4: ((uint32_t*)b)[i] = (uint32_t)v; break;
    default: ((unsigned long long*)b)[i] = v; break;
  }
}

// ---- the chunks' row lists -------------------------------------------------

// One block a chunk: its member rows by (slot, row) and their segments;
// rows[p] += the slot's member rows. scratch: C + 2P + 1 ints a chunk.
__global__ void __launch_bounds__(kRankThreads)
chunks_kernel(const bool* v, const int32_t* slot, int C, int P, int32_t* srow, int32_t* seg_slot,
              int32_t* seg_lo, int32_t* seg_hi, int32_t* nseg, int32_t* rows,
              int32_t* scratch) {
  __shared__ RankSmem s;
  const int i = blockIdx.x;
  const long long cb = (long long)i * C;
  int32_t* base = scratch + (long long)i * (C + 2 * P + 1);
  int32_t* rank = base;
  int32_t* slot_start = base + C;
  int32_t* counters = slot_start + P + 1;
  int32_t* list = srow + cb;
  auto slot_of = [&](int r) { return v[cb + r] ? slot[cb + r] : -1; };
  const int nmem = member_rows(C, P, slot_of, rank, list, slot_start, counters, s);
  // segments: runs of one slot in the list
  int carry = 0;
  for (int b0 = 0; b0 < C; b0 += kRankThreads) {
    const int k = b0 + threadIdx.x;
    int sl = -1;
    bool start = false, end = false;
    if (k < nmem) {
      sl = slot[cb + list[k]];
      start = k == 0 || slot[cb + list[k - 1]] != sl;
      end = k == nmem - 1 || slot[cb + list[k + 1]] != sl;
    }
    int tot;
    const int x = carry + block_excl_sum(start ? 1 : 0, s.ws, &tot);
    if (start) {
      seg_slot[cb + x] = sl;
      seg_lo[cb + x] = (int)(cb + k);
    }
    if (end) seg_hi[cb + x + (start ? 1 : 0) - 1] = (int)(cb + k + 1);
    if (k < nmem) atomicAdd(&rows[sl], 1);
    carry += tot;
  }
  if (threadIdx.x == 0) nseg[i] = carry;
  __syncthreads();
  for (int k = threadIdx.x; k < nmem; k += kRankThreads) list[k] += (int)cb;  // global rows
}

// ---- K34: one NFA slot's pass ---------------------------------------------

struct Cond {
  const bool* c;      // strided [1 or P*T, C] condition
  long long cst, csc;
  const int64_t* ts;  // [rows] timestamps
  int has_win;
  long long win;
};

// row j (chunk-local, global row r) meets lane g's condition and within
__device__ __forceinline__ bool cond_ok(const Cond& K, long long g, int j, long long r,
                                        int64_t start) {
  if (!K.c[g * K.cst + j * K.csc]) return false;
  return !(K.has_win && start >= 0 && K.ts[r] - start > K.win);
}

__device__ __forceinline__ void write_col0(const Lanes& L, long long g, long long r) {
  for (int l = 0; l < L.n; ++l)
    st(L.lane[l], g * L.width[l], L.size[l], ld(L.src[l], r, L.size[l]));
}

__global__ void advance_kernel(bool* active, int32_t* slot, int64_t* start_ts, int64_t* entry_ts,
                               int32_t* entry_row, int32_t* n, Cond K, int T, int C, int chunk,
                               int p, int strict, int set_start, Seg sg, Lanes L) {
  const long long cb = (long long)chunk * C;
  const int s = blockIdx.x;
  if (s >= sg.nseg[chunk]) return;
  const int q = sg.slot[cb + s], lo = sg.lo[cb + s], hi = sg.hi[cb + s];
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const long long g = (long long)q * T + t;
    if (!(active[g] && slot[g] == p)) continue;
    const int er = entry_row[g];
    const int64_t stt = start_ts[g];
    int hit = -1;
    long long hrow = -1;
    bool die = false;
    for (int k = lo; k < hi; ++k) {
      const long long r = sg.srow[k];
      const int j = (int)(r - cb);
      if (j <= er) continue;
      const bool ok = cond_ok(K, g, j, r, stt);
      if (ok) {
        hit = j;
        hrow = r;
      }
      if (ok || strict) {
        die = !ok;  // strict: the first row after the entry decides
        break;
      }
    }
    if (die) active[g] = false;
    if (hit >= 0) {
      const int64_t mts = K.ts[hrow];
      slot[g] = p + 1;
      if (set_start && stt < 0) start_ts[g] = mts;
      entry_ts[g] = mts;
      entry_row[g] = hit;
      n[g] = 1;
      write_col0(L, g, hrow);
    }
  }
}

__global__ void fork_kernel(bool* active, int32_t* slot, int64_t* start_ts, int64_t* entry_ts,
                            int32_t* entry_row, int32_t* n, Cond K, int T, int C, int chunk, int p,
                            Seg sg, Lanes L, int32_t* scratch, bool* ovf) {
  __shared__ int ws[32];
  const long long cb = (long long)chunk * C;
  const int s = blockIdx.x;
  if (s >= sg.nseg[chunk]) return;
  const int q = sg.slot[cb + s], lo = sg.lo[cb + s], hi = sg.hi[cb + s];
  const long long tb = (long long)q * T;
  int32_t* etok = scratch + 2 * tb;
  int32_t* freel = etok + T;
  // the slot's eligible tokens and free lanes, in lane order
  int ne = 0, nfree = 0;
  for (int b0 = 0; b0 < T; b0 += blockDim.x) {
    const int t = b0 + threadIdx.x;
    bool e = false, f = false;
    if (t < T) {
      const bool a = active[tb + t];
      e = a && slot[tb + t] == p;
      f = !a;
    }
    int te, tf;
    const int xe = block_excl_sum(e, ws, &te);
    const int xf = block_excl_sum(f, ws, &tf);
    if (e) etok[ne + xe] = t;
    if (f) freel[nfree + xf] = t;
    ne += te;
    nfree += tf;
  }
  __syncthreads();
  // each forking row takes the free lane of its rank among the forks
  int carry = 0;
  bool over = false;
  for (int b0 = lo; b0 < hi; b0 += blockDim.x) {
    const int k = b0 + threadIdx.x;
    bool fk = false;
    long long r = 0;
    int j = 0;
    if (k < hi) {
      r = sg.srow[k];
      j = (int)(r - cb);
      for (int e = 0; e < ne && !fk; ++e) {
        const long long ge = tb + etok[e];
        fk = j > entry_row[ge] && cond_ok(K, ge, j, r, start_ts[ge]);
      }
    }
    int total;
    const int rk = carry + block_excl_sum(fk, ws, &total);
    if (fk) {
      if (rk < nfree) {
        const long long d = tb + freel[rk];
        const int64_t mts = K.ts[r];
        active[d] = true;
        slot[d] = p + 1;
        start_ts[d] = mts;
        entry_ts[d] = mts;
        entry_row[d] = j;
        n[d] = 1;
        write_col0(L, d, r);
      } else {
        over = true;
      }
    }
    carry += total;
    __syncthreads();
  }
  if (__syncthreads_or(over) && threadIdx.x == 0) *ovf = true;
}

// ---- K35: the closed-form count pass ----------------------------------------

__device__ __forceinline__ int clampi(long long x, int lo, int hi) {
  return x < lo ? lo : x > hi ? hi : (int)x;
}

struct CountSeg {
  const int32_t* srow;
  const int32_t* midx;  // [C] by (k - cb): matches among the segment's rows before k
  const int32_t* mk;    // the x-th match's list index k (absolute)
  const int32_t* anext; // [C] by (k - cb): the first advance row's k at or after k, hi if none
  long long cb;
  int lo, hi, k_total;
};

// the first advance row after the thresh-th match (K14's searchsorted of
// thresh into the match ranks, then the next advance row): its list index,
// or hi
__device__ __forceinline__ int adv_after(const CountSeg& G, long long thresh) {
  int k0;
  if (thresh <= 0) k0 = G.lo;
  else if (thresh <= G.k_total) k0 = G.mk[thresh - 1] + 1;
  else k0 = G.hi;
  return k0 < G.hi ? G.anext[k0 - G.cb] : G.hi;
}

// the row of match x
__device__ __forceinline__ long long match_row(const CountSeg& G, long long x) {
  return G.srow[G.mk[x]];
}

__global__ void count_kernel(const bool* Mc, const bool* Madv, const int64_t* ts, bool* active,
                             int32_t* slot, int64_t* start_ts, int64_t* entry_ts,
                             int32_t* entry_row, int32_t* n0, int32_t* n1, int T, int C, int chunk,
                             int Kcap, int m, int Mmax, int persistent, int has_ev1, int Gmax,
                             Seg sg, Lanes L, int32_t* scratch, bool* ovf) {
  __shared__ int ws[32];
  __shared__ int s_ny, s_tail;
  const long long cb = (long long)chunk * C;
  const int s = blockIdx.x;
  if (s >= sg.nseg[chunk]) return;
  const int q = sg.slot[cb + s], lo = sg.lo[cb + s], hi = sg.hi[cb + s];
  const long long tb = (long long)q * T;
  int32_t* midx = scratch;
  int32_t* mk = scratch + C;
  int32_t* anext = scratch + 2 * C;
  int32_t* freel = scratch + 3 * C + tb;
  // the segment's match ranks and match list
  int k_total = 0;
  for (int b0 = lo; b0 < hi; b0 += blockDim.x) {
    const int k = b0 + threadIdx.x;
    const bool mc = k < hi && Mc[sg.srow[k]];
    int total;
    const int x = k_total + block_excl_sum(mc, ws, &total);
    if (k < hi) midx[k - cb] = x;
    if (mc) mk[lo - cb + x] = k;
    k_total += total;
  }
  // the next advance row, a min scan from the end
  int carry = hi;
  for (int end = hi; end > lo; end -= blockDim.x) {
    const int k = end - 1 - (int)threadIdx.x;
    int tmin;
    const int incl = block_incl_min(k >= lo && Madv[sg.srow[k]] ? k : hi, ws, &tmin);
    if (k >= lo) anext[k - cb] = incl < carry ? incl : carry;
    carry = tmin < carry ? tmin : carry;
  }
  // the youngest pending token below min, the free lanes
  int ny = m, nfree = 0;
  bool tail = false;
  for (int b0 = 0; b0 < T; b0 += blockDim.x) {
    const int t = b0 + threadIdx.x;
    bool f = false;
    int tn = m;
    if (t < T) {
      const long long g = tb + t;
      const bool a = active[g];
      f = !a;
      if (a && slot[g] == 0 && n0[g] < m) {
        tail = true;
        tn = n0[g];
      }
    }
    int tmin;
    block_incl_min(tn, ws, &tmin);
    ny = tmin < ny ? tmin : ny;
    int total;
    const int x = block_excl_sum(f, ws, &total);
    if (f && nfree + x < Gmax) freel[nfree + x] = t;
    nfree += total;
  }
  tail = __syncthreads_or(tail);
  __syncthreads();
  // (the match list starts at the segment's own place in the scratch)
  const CountSeg Gs{sg.srow, midx, mk + (lo - cb), anext, cb, lo, hi, k_total};
  // 1. tokens at slot 0 absorb their matches up to their advance row; every
  //    other lane of the slot leaves the chunk with no entry row
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    const long long g = tb + t;
    if (!(active[g] && slot[g] == 0)) {
      entry_row[g] = -1;
      continue;
    }
    const int nn = n0[g];
    const int thresh = m - clampi(nn, 0, m);
    const int room = Mmax - clampi(nn, 0, Mmax);
    const int jk = adv_after(Gs, thresh);
    const bool has = jk < hi;
    int A = has ? midx[jk - cb] : k_total;
    A = A < 0 ? 0 : A > room ? room : A;
    n0[g] = nn + A;
    for (int l = 0; l < L.n; ++l) {
      if (L.map[l] != 0) continue;
      const int w = L.width[l];
      for (int qq = 0; qq < w; ++qq) {
        const int src = qq - nn;
        if (src >= 0 && src < A)
          st(L.lane[l], g * w + qq, L.size[l], ld(L.src[l], match_row(Gs, src), L.size[l]));
      }
    }
    const int64_t stt = start_ts[g];
    if (stt < 0 && A > 0) start_ts[g] = ts[match_row(Gs, 0)];
    if (has) {
      const long long r = sg.srow[jk];
      slot[g] = 2;
      entry_ts[g] = ts[r];
      entry_row[g] = (int)(r - cb);
      if (has_ev1) n1[g] = 1;
      for (int l = 0; l < L.n; ++l)
        if (L.map[l] == 1) st(L.lane[l], g * L.width[l], L.size[l], ld(L.src[l], r, L.size[l]));
    } else {
      entry_row[g] = -1;
    }
  }
  __syncthreads();
  // 2. the `every` generation chain: generation g arms at the
  //    (m - ny + g*m)-th match, into the slot's g-th free lane
  bool over = false;
  if (persistent) {
    over = tail && (long long)(m - ny) + (long long)Gmax * m <= k_total;
    for (int gi = threadIdx.x; gi < Gmax; gi += blockDim.x) {
      const long long sg0 = (long long)(m - ny) + (long long)gi * m;
      if (!(tail && sg0 <= k_total)) continue;
      if (gi >= nfree) {
        over = true;
        continue;
      }
      const int jk = adv_after(Gs, sg0 + m);
      const bool has = jk < hi;
      long long Ag = (has ? midx[jk - cb] : k_total) - sg0;
      Ag = Ag < 0 ? 0 : Ag > Mmax ? Mmax : Ag;
      const long long d = tb + freel[gi];
      active[d] = true;
      slot[d] = has ? 2 : 0;
      start_ts[d] = Ag > 0 ? ts[match_row(Gs, sg0)] : -1;
      entry_ts[d] = ts[match_row(Gs, sg0 - 1)];
      entry_row[d] = has ? (int)(sg.srow[jk] - cb) : -1;
      n0[d] = (int)Ag;
      if (has_ev1) n1[d] = has;
      for (int l = 0; l < L.n; ++l) {
        const int w = L.width[l], mp = L.map[l];
        for (int qq = 0; qq < w; ++qq) {
          unsigned long long val = (unsigned long long)L.null_bits[l];
          if (mp == 0 && qq < Ag) val = ld(L.src[l], match_row(Gs, sg0 + qq), L.size[l]);
          if (mp == 1) {
            if (qq > 0) break;  // only the first capture
            if (has) val = ld(L.src[l], sg.srow[jk], L.size[l]);
          }
          st(L.lane[l], d * w + qq, L.size[l], val);
        }
      }
    }
  }
  if (__syncthreads_or(over) && threadIdx.x == 0) *ovf = true;
}

// ---- K36: the completions and the within purge ------------------------------

__global__ void emit_kernel(bool* active, const int32_t* slot, const int64_t* start_ts,
                            int32_t* entry_row, int T, int S, const int64_t* ts, int C, int chunk,
                            const int64_t* now, int64_t* out_ts, bool* out_valid,
                            const long long* off, const int32_t* cap, int32_t* n_slot, bool* ovf,
                            int purge, const int64_t* win_by_slot, int armer, Seg sg, Lanes L,
                            int32_t* scratch) {
  __shared__ int ws[32];
  __shared__ long long keys[kThreads];
  __shared__ long long wmax[kThreads / 32];
  const long long cb = (long long)chunk * C;
  const int s = blockIdx.x;
  if (s >= sg.nseg[chunk]) return;
  const int q = sg.slot[cb + s], lo = sg.lo[cb + s], hi = sg.hi[cb + s];
  const long long tb = (long long)q * T;
  int32_t* dlist = scratch + 2 * tb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the purge clock: the slot's last row in the chunk (JAX max(where(v, ts,
  // 0)), so 0 unless the slot holds every row of the chunk)
  long long last = hi - lo < C ? 0 : -(1LL << 62);
  for (int k = lo + tid; k < hi; k += blockDim.x) {
    const long long x = ts[sg.srow[k]];
    last = x > last ? x : last;
  }
  for (int d = 16; d > 0; d >>= 1) {
    const long long y = __shfl_down_sync(kFull, last, d);
    last = y > last ? y : last;
  }
  if (lane == 0) wmax[warp] = last;
  // the done tokens, in lane order
  int D = 0;
  for (int b0 = 0; b0 < T; b0 += blockDim.x) {
    const int t = b0 + tid;
    const bool done = t < T && active[tb + t] && slot[tb + t] == S;
    int total;
    const int x = block_excl_sum(done, ws, &total);
    if (done) dlist[D + x] = t;
    D += total;
  }
  __syncthreads();
  last = wmax[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) last = wmax[w] > last ? wmax[w] : last;
  const int base = n_slot[q];
  const int room = cap[q] - base;
  const long long ob = off[q] + base;
  // rank = the done tokens with a smaller (completion row, lane) key
  for (int i0 = 0; i0 < D; i0 += blockDim.x) {
    const int i = i0 + tid;
    int ti = -1;
    long long ki = 0;
    if (i < D) {
      ti = dlist[i];
      ki = (long long)entry_row[tb + ti] * T + ti;
    }
    int rank = 0;
    for (int k0 = 0; k0 < D; k0 += blockDim.x) {
      __syncthreads();
      if (k0 + tid < D) {
        const int tk = dlist[k0 + tid];
        keys[tid] = (long long)entry_row[tb + tk] * T + tk;
      }
      __syncthreads();
      const int nk = D - k0 < (int)blockDim.x ? D - k0 : (int)blockDim.x;
      if (i < D)
        for (int x = 0; x < nk; ++x) rank += keys[x] < ki;
    }
    if (i < D && rank < room) {
      const long long o = ob + rank;
      const int er = entry_row[tb + ti];
      out_ts[o] = er >= 0 ? ts[cb + er] : *now;
      out_valid[o] = true;
      for (int l = 0; l < L.n; ++l) {
        const int w = L.width[l];
        for (int x = 0; x < w; ++x)
          st(L.lane[l], o * w + x, L.size[l], ld(L.src[l], (tb + ti) * w + x, L.size[l]));
      }
    }
  }
  __syncthreads();
  // done tokens leave the table, expired ones are purged (not the armer);
  // the entry rows go back to -1 for the next chunk
  for (int t = tid; t < T; t += blockDim.x) {
    const long long g = tb + t;
    const int sl = slot[g];
    bool a = active[g] && sl != S;
    if (purge && a) {
      const long long stt = start_ts[g];
      const int sc = sl < 0 ? 0 : sl > S ? S : sl;
      if (stt >= 0 && last - stt > win_by_slot[sc] && !(armer && t == 0)) a = false;
    }
    active[g] = a;
    entry_row[g] = -1;
  }
  if (tid == 0) {
    n_slot[q] = base + (D < room ? D : room);
    if (D > room) *ovf = true;
  }
}

// ---- the placement of the emissions ------------------------------------------

__global__ void __launch_bounds__(kRankThreads)
place_stretch_kernel(int P, const int32_t* n, const int32_t* cap, int32_t* nq, int32_t* n_start,
                     int32_t* pos_base, int32_t* oidx, int32_t* counters, int32_t* info) {
  __shared__ RankSmem s;
  for (int p = threadIdx.x; p < P; p += kRankThreads) nq[p] = n[p] < cap[p] ? n[p] : cap[p];
  __syncthreads();
  int maxn;
  const int R = place_by_position(P, nq, n_start, pos_base, oidx, counters, &maxn, s);
  if (threadIdx.x == 0) {
    info[0] = R;
    info[1] = maxn;
  }
}

__global__ void place_rows_kernel(int P, int rows, const long long* off, const int32_t* nq,
                                  const int32_t* n_start, const int32_t* oidx,
                                  const int32_t* info, int32_t* out_slot, int32_t* out_first,
                                  int32_t* src) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= rows) return;
  const int R = info[0];
  if (t < R) {
    const int q = slot_of_item(n_start, P, t);
    const int f = oidx[t];
    src[f] = (int32_t)(off[q] + (t - n_start[q]));
    out_slot[f] = q;
    out_first[f] = oidx[n_start[q]];
  } else {
    src[t] = -1;
    out_slot[t] = P;
    out_first[t] = t;
  }
}

__global__ void gather_kernel(const void* lane, const int32_t* src, void* out, int rows, int w,
                              int size) {
  const long long n = (long long)rows * w;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / w, x = i % w;
    const int s = src[r];
    st(out, i, size, s >= 0 ? ld(lane, (long long)s * w + x, size) : 0ULL);
  }
}

Lanes pack(int n_lanes, void* const* lane, const void* const* src, const int* size,
           const int* width, const int* map, const long long* null_bits) {
  Lanes L{};
  L.n = n_lanes;
  for (int l = 0; l < n_lanes; ++l) {
    L.lane[l] = lane[l];
    L.src[l] = src[l];
    L.size[l] = size[l];
    L.width[l] = width[l];
    L.map[l] = map != nullptr ? map[l] : 0;
    L.null_bits[l] = null_bits != nullptr ? null_bits[l] : 0;
  }
  return L;
}

}  // namespace

extern "C" {

// The chunks of a padded batch of n = k*C rows: v [n] the member rows,
// slot [n] int32. Out: srow, seg_slot, seg_lo, seg_hi [n], nseg [k], rows
// [P] (each slot's member rows). scratch: int32 [k * (C + 2P + 1)].
int pp_chunks(const bool* v, const int32_t* slot, int n, int C, int P, int32_t* srow,
              int32_t* seg_slot, int32_t* seg_lo, int32_t* seg_hi, int32_t* nseg, int32_t* rows,
              int32_t* scratch, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(rows, 0, sizeof(int32_t) * P, stream);
  if (e != cudaSuccess) return (int)e;
  chunks_kernel<<<n / C, kRankThreads, 0, stream>>>(v, slot, C, P, srow, seg_slot, seg_lo, seg_hi,
                                                     nseg, rows, scratch);
  return (int)cudaGetLastError();
}

// K34: NFA slot p's pass over chunk `chunk` for each segment (one block a
// segment, `grid` blocks at least the chunk's segments). In place: the
// [P*T] token lanes, entry_row, the ref's count n and its capture lanes
// (lane l [P*T, width]: column 0 gets src[row]); ovf set on a fork past
// the slot's free lanes. cond: strided [1 or P*T, C]. scratch: int32
// [2 P T] (fork only).
int pp_advance(bool* active, int32_t* slot, int64_t* start_ts, int64_t* entry_ts,
               int32_t* entry_row, int32_t* n, const int64_t* ts, const bool* cond,
               long long cst, long long csc, int T, int C, int chunk, int p, int fork, int strict,
               int set_start, int has_win, long long win, const int32_t* srow,
               const int32_t* seg_slot, const int32_t* seg_lo, const int32_t* seg_hi,
               const int32_t* nseg, int grid, bool* ovf, int32_t* scratch, int n_lanes,
               void* const* lane, const void* const* src, const int* size, const int* width,
               cudaStream_t stream) {
  if (n_lanes > kMaxL) return (int)cudaErrorInvalidValue;
  const Cond K{cond, cst, csc, ts, has_win, win};
  const Seg sg{srow, seg_slot, seg_lo, seg_hi, nseg};
  const Lanes L = pack(n_lanes, lane, src, size, width, nullptr, nullptr);
  if (fork) {
    fork_kernel<<<grid, kThreads, 0, stream>>>(active, slot, start_ts, entry_ts, entry_row, n, K,
                                               T, C, chunk, p, sg, L, scratch, ovf);
  } else {
    advance_kernel<<<grid, kThreads, 0, stream>>>(active, slot, start_ts, entry_ts, entry_row, n,
                                                  K, T, C, chunk, p, strict, set_start, sg, L);
  }
  return (int)cudaGetLastError();
}

// K35: the count pass of chunk `chunk` for each segment. Mc / Madv [rows]:
// slot 0's and slot 1's conditions with the member rows. In place: the
// token lanes, entry_row, both counts and the capture lanes (map 0: ref
// 0's [P*T, K]; 1: ref 1's column 0; 2: cleared in a generation's lane).
// scratch: int32 [3C + P T + 8].
int pp_count(const bool* Mc, const bool* Madv, const int64_t* ts, bool* active, int32_t* slot,
             int64_t* start_ts, int64_t* entry_ts, int32_t* entry_row, int32_t* n0, int32_t* n1,
             int T, int C, int chunk, int Kcap, int m, int Mmax, int persistent, int has_ev1,
             int Gmax, const int32_t* srow, const int32_t* seg_slot, const int32_t* seg_lo,
             const int32_t* seg_hi, const int32_t* nseg, int grid, bool* ovf, int32_t* scratch,
             int n_lanes, void* const* lane, const void* const* src, const int* size,
             const int* width, const int* map, const long long* null_bits, cudaStream_t stream) {
  if (n_lanes > kMaxL) return (int)cudaErrorInvalidValue;
  const Seg sg{srow, seg_slot, seg_lo, seg_hi, nseg};
  const Lanes L = pack(n_lanes, lane, src, size, width, map, null_bits);
  count_kernel<<<grid, kThreads, 0, stream>>>(Mc, Madv, ts, active, slot, start_ts, entry_ts,
                                              entry_row, n0, n1, T, C, chunk, Kcap, m, Mmax,
                                              persistent, has_ev1, Gmax, sg, L, scratch, ovf);
  return (int)cudaGetLastError();
}

// K36: the completions of chunk `chunk` for each segment, into each slot's
// stretch of the emission lanes (off [P], cap [P], n_slot [P] in place;
// lane l: dst [E, width] from the token lane src [P*T, width]). In place:
// active, entry_row (-1 for the slot's lanes), ovf. scratch: int32 [2 P T].
int pp_emit(bool* active, const int32_t* slot, const int64_t* start_ts, int32_t* entry_row,
            int T, int S, const int64_t* ts, int C, int chunk, const int64_t* now,
            int64_t* out_ts, bool* out_valid, const long long* off, const int32_t* cap,
            int32_t* n_slot, bool* ovf, int purge, const int64_t* win_by_slot, int armer,
            const int32_t* srow, const int32_t* seg_slot, const int32_t* seg_lo,
            const int32_t* seg_hi, const int32_t* nseg, int grid, int32_t* scratch, int n_lanes,
            const void* const* src, void* const* dst, const int* size, const int* width,
            cudaStream_t stream) {
  if (n_lanes > kMaxL) return (int)cudaErrorInvalidValue;
  const Seg sg{srow, seg_slot, seg_lo, seg_hi, nseg};
  Lanes L = pack(n_lanes, dst, src, size, width, nullptr, nullptr);
  emit_kernel<<<grid, kThreads, 0, stream>>>(active, slot, start_ts, entry_row, T, S, ts, C, chunk,
                                             now, out_ts, out_valid, off, cap, n_slot, ovf, purge,
                                             win_by_slot, armer, sg, L, scratch);
  return (int)cudaGetLastError();
}

// The placement of the stretches: nq [P] = min(n, cap), n_start [P + 1],
// pos_base, oidx (partition.cuh's), info[0] the rows, info[1] the most of
// a slot. counters: a global [max(P, max nq) + 1] scratch.
int pp_place(int P, const int32_t* n, const int32_t* cap, int32_t* nq, int32_t* n_start,
             int32_t* pos_base, int32_t* oidx, int32_t* counters, int32_t* info,
             cudaStream_t stream) {
  place_stretch_kernel<<<1, kRankThreads, 0, stream>>>(P, n, cap, nq, n_start, pos_base, oidx,
                                                       counters, info);
  return (int)cudaGetLastError();
}

// Each flattened row's slot, its slot's first row and its source row in
// the stretches (-1 past the rows); `rows` = max(info[0], 1).
int pp_place_rows(int P, int rows, const long long* off, const int32_t* nq,
                  const int32_t* n_start, const int32_t* oidx, const int32_t* info,
                  int32_t* out_slot, int32_t* out_first, int32_t* src, cudaStream_t stream) {
  place_rows_kernel<<<(rows + 255) / 256, 256, 0, stream>>>(P, rows, off, nq, n_start, oidx,
                                                            info, out_slot, out_first, src);
  return (int)cudaGetLastError();
}

// out [rows, w] = lane [src[r], w] (0 where src < 0).
int pp_gather(const void* lane, const int32_t* src, void* out, int rows, int w, int size,
              cudaStream_t stream) {
  const long long n = (long long)rows * w;
  int blocks = (int)((n + 255) / 256);
  blocks = blocks > 4096 ? 4096 : blocks < 1 ? 1 : blocks;
  gather_kernel<<<blocks, 256, 0, stream>>>(lane, src, out, rows, w, size);
  return (int)cudaGetLastError();
}

}  // extern "C"
