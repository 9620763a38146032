// K25-K28: the sort, frequent, lossyFrequent and cron window steps (K40-K43:
// the same inside a partition).
//
// Each of these windows is a per-arrival state machine: an arrival may evict
// a victim that depends on every earlier arrival (the sort order, the
// Misra-Gries counts, the lossy-counting buckets, the open cron bucket).
// The JAX package scans the batch's rows (windows_special.py); here one
// block walks the rows in order, one tile at a time:
//   - the block loads a tile's row lanes (kind/valid flags, ts, keys) into
//     shared memory, then one worker walks the tile: thread 0 for sort and
//     cron, warp 0 for frequent and lossyFrequent, whose slot searches
//     (first hit, first free, the evictions in slot order) are warp ballots;
//   - the slots' control lanes (sort keys and seq, frequent keys/counts,
//     bucket lanes) sit in shared memory when they fit, else in a global
//     scratch the wrapper passes;
//   - the walk writes no column: it records, for each output row and each
//     state slot, where its data comes from (`src`: a state slot or a batch
//     row, or -1 for zeros), and `sw_gather` then fills every column lane
//     from that map, all lanes in one launch.
// Output rows past the emitted count keep zeros (valid false), as the JAX
// package's fixed-capacity buffer does; an emission past the capacity is
// dropped and sets the overflow flag.
// What bounds it on the card: the walk is sequential over the rows (each
// arrival depends on the previous), so latency, not bytes: a few shared
// memory round trips per row, plus the victim fold of a full sort window
// (w + 1 candidates by one thread, in slot order: the fold is not a max
// when keys hold NaN, so it is not a tree reduction).
// K40/K41 run the sort and frequent windows of every partition at once
// (siddhi_tpu/core/partition.py:105 `_vmapped` over `SortWindow.apply` and
// `FrequentWindow.apply`): a warp a partition slot walks that slot's rows
// with the same per-arrival code as K25/K26 (`sort_arrive`,
// `frequent_arrive`), its slot lanes in a global scratch and its emissions
// in its own stretch; the wrapper then places the stretches by (position,
// slot). Slots run in parallel, so a step takes the walk of its busiest
// slot, not of the batch. K42/K43 do the same for the lossyFrequent and cron
// windows (`lossy_arrive`, K27's per-arrival code with the slot's own total,
// its key table in shared memory when four fit in a block; `cron_row`, K28's
// per-row code, now walked by a warp, over the slot's rows merged with the
// batch's TIMER rows, which reach every slot).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 256;
constexpr int kMaxSortKeys = 16;
constexpr int kSlotWarps = 4;  // K40/K41: slots (warps) a block
constexpr int8_t kCurrent = 0, kExpired = 1, kTimer = 2, kReset = 3;

struct SortKeys {
  const void* state[kMaxSortKeys];
  const void* batch[kMaxSortKeys];
  int type[kMaxSortKeys];  // 0 float32, 1 int32, 2 int64, 3 bool
  int desc[kMaxSortKeys];
  int k;
};

union Key {
  float f;
  long long i;
};

// One sort key as the comparator sees it: `-c` for a descending key, with
// the integer negation in unsigned arithmetic (it wraps, as two's complement
// does in the JAX package), bool widened to int32 first.
__device__ __forceinline__ Key load_key(const void* p, long long idx, int type, int desc) {
  Key out;
  out.i = 0;
  switch (type) {
    case 0: {
      const float v = flush_subnormal(((const float*)p)[idx]);  // as XLA compares
      out.f = desc ? -v : v;
      break;
    }
    case 1: {
      unsigned u = (unsigned)((const int*)p)[idx];
      if (desc) u = 0u - u;
      out.i = (long long)(int)u;
      break;
    }
    case 2: {
      unsigned long long u = (unsigned long long)((const long long*)p)[idx];
      if (desc) u = 0ull - u;
      out.i = (long long)u;
      break;
    }
    default: {
      unsigned u = ((const unsigned char*)p)[idx] ? 1u : 0u;
      if (desc) u = 0u - u;
      out.i = (long long)(int)u;
      break;
    }
  }
  return out;
}

struct Out {
  int32_t* src;
  int64_t* ts;
  int8_t* kind;
  bool* valid;
  int cap;
  int n;
  bool ovf;

  // _out_append: one row, dropped (flag set) past the capacity
  __device__ __forceinline__ void append(int s, long long t, int8_t k) {
    if (n < cap) {
      src[n] = s;
      ts[n] = t;
      kind[n] = k;
      valid[n] = true;
      ++n;
    } else {
      ovf = true;
    }
  }
};

// zeros in every output row (the empty buffer the walk appends into)
__device__ __forceinline__ void clear_out(Out& o) {
  for (int i = threadIdx.x; i < o.cap; i += blockDim.x) {
    o.src[i] = -1;
    o.ts[i] = 0;
    o.kind[i] = 0;
    o.valid[i] = false;
  }
}

__device__ __forceinline__ int row_flags(const bool* valid, const int8_t* kind, int r) {
  if (!valid[r]) return 0;
  return kind[r] == kCurrent ? 1 : kind[r] == kTimer ? 2 : 0;
}

// ---------------------------------------------------------------------------
// K25: sort
// ---------------------------------------------------------------------------

// a > b for the comparator: lexicographic over the keys, then seq; NaN is
// neither greater nor equal (JAX's `gt |= eq & (a > b); eq &= a == b`)
template <int KK>
__device__ __forceinline__ bool key_gt(const SortKeys& K, int k, const Key* a, long long as,
                                       const Key* b, long long bs) {
  bool gt = false, eq = true;
#pragma unroll
  for (int q = 0; q < KK; ++q) {
    if (q < k) {
      if (K.type[q] == 0) {
        gt = gt || (eq && a[q].f > b[q].f);
        eq = eq && a[q].f == b[q].f;
      } else {
        gt = gt || (eq && a[q].i > b[q].i);
        eq = eq && a[q].i == b[q].i;
      }
    }
  }
  return gt || (eq && as > bs);
}

// The slot lanes of one sort window as its walk sees them: keys [k][W],
// seq, src (where each slot's data comes from), occupied and NaN flags, and
// the walk's counters (occupied and NaN slots, the first free slot: kept by
// lane 0 alone, slots only ever fill) and the next seq.
struct SortSlots {
  Key* skey;
  long long* sseq;
  int* ssrc;
  unsigned char* socc;
  unsigned char* snan;
  int W;
  int occ_count;
  int nan_slots;
  int first_free;
  long long nx;
};

// Point s at its lanes in `base` (16-byte aligned) and load them from a
// window's state: slot j's source is src0 + j. The warp's lanes load.
__device__ __forceinline__ void sort_slots_load(SortSlots& s, char* base, const SortKeys& K,
                                                int k, int W, long long off, const bool* occ,
                                                const int64_t* seq, long long nx, int src0,
                                                int lane, int stride) {
  s.skey = (Key*)base;
  s.sseq = (long long*)(s.skey + (size_t)k * W);
  s.ssrc = (int*)(s.sseq + W);
  s.socc = (unsigned char*)(s.ssrc + W);
  s.snan = s.socc + W;
  s.W = W;
  s.first_free = 0;
  s.nx = nx;
  for (int j = lane; j < W; j += stride) {
    unsigned char nan = 0;
    for (int q = 0; q < k; ++q) {
      const Key v = load_key(K.state[q], off + j, K.type[q], K.desc[q]);
      s.skey[(size_t)q * W + j] = v;
      nan |= K.type[q] == 0 && isnan(v.f);
    }
    s.sseq[j] = seq[off + j];
    s.ssrc[j] = src0 + j;
    s.socc[j] = occ[off + j] ? 1 : 0;
    s.snan[j] = nan;
  }
}

// The occupied and NaN slot counts, summed by one warp (after the load).
__device__ __forceinline__ void sort_slots_count(SortSlots& s, int lane) {
  int occ_count = 0, nan_slots = 0;
  for (int j = lane; j < s.W; j += 32) {
    occ_count += s.socc[j];
    nan_slots += s.snan[j];
  }
  for (int d = 16; d > 0; d >>= 1) {
    occ_count += __shfl_xor_sync(kFull, occ_count, d);
    nan_slots += __shfl_xor_sync(kFull, nan_slots, d);
  }
  s.occ_count = occ_count;
  s.nan_slots = nan_slots;
}

// One CURRENT arrival through a sort window (windows_special.py's scan
// body): its CURRENT row (source asrc), then, when the window is full, the
// greatest of the W slots and the arrival as EXPIRED at t_now and the
// arrival in the victim's slot; else the arrival in the first free slot.
// The arrival's keys are akey[q * astride], anan when one is NaN. Every
// lane of one warp calls it.
template <int NK>
__device__ __forceinline__ void sort_arrive(const SortKeys& K, int k, SortSlots& s, Out& o,
                                            const Key* akey, int astride, unsigned char anan,
                                            long long ats, int asrc, long long t_now) {
  constexpr int kKeys = NK > 0 ? NK : kMaxSortKeys;
  const int lane = threadIdx.x & 31;
  const int W = s.W;
  if (lane == 0) o.append(asrc, ats, kCurrent);
  if (s.occ_count == W) {
    // candidate i < W is slot i, candidate W the arrival
    auto load = [&](int i, Key* a) -> long long {
#pragma unroll
      for (int q = 0; q < kKeys; ++q) {
        if (q < k) a[q] = i < W ? s.skey[(size_t)q * W + i] : akey[(size_t)q * astride];
      }
      return i < W ? s.sseq[i] : s.nx;
    };
    int best = 0;
    if (s.nan_slots == 0 && !anan) {
      // no NaN key: the comparator is a strict total order (seq breaks
      // every tie), so the fold is the argmax, found by the warp
      int bi = -1;
      Key bk[kKeys], ak[kKeys];
      long long bs = 0;
      for (int i = lane; i <= W; i += 32) {
        const long long as = load(i, ak);
        if (bi < 0 || key_gt<kKeys>(K, k, ak, as, bk, bs)) {
          bi = i;
          bs = as;
#pragma unroll
          for (int q = 0; q < kKeys; ++q) bk[q] = ak[q];
        }
      }
      for (int d = 16; d > 0; d >>= 1) {
        const int oi = __shfl_xor_sync(kFull, bi, d);
        const long long os = __shfl_xor_sync(kFull, bs, d);
#pragma unroll
        for (int q = 0; q < kKeys; ++q) {
          if (q < k) ak[q].i = __shfl_xor_sync(kFull, bk[q].i, d);
        }
        if (oi >= 0 && (bi < 0 || key_gt<kKeys>(K, k, ak, os, bk, bs))) {
          bi = oi;
          bs = os;
#pragma unroll
          for (int q = 0; q < kKeys; ++q) bk[q] = ak[q];
        }
      }
      best = bi;
    } else if (lane == 0) {
      // the left-to-right fold of windows_special.py: best moves to i
      // when i is greater (a NaN key in slot 0 is never replaced)
      Key bk[kKeys], ak[kKeys];
      long long bs = load(0, bk);
      for (int i = 1; i <= W; ++i) {
        const long long as = load(i, ak);
        if (key_gt<kKeys>(K, k, ak, as, bk, bs)) {
          best = i;
          bs = as;
#pragma unroll
          for (int q = 0; q < kKeys; ++q) bk[q] = ak[q];
        }
      }
    }
    if (lane == 0) {
      o.append(best == W ? asrc : s.ssrc[best], t_now, kExpired);
      if (best < W) {  // the arrival takes the victim's slot
        for (int q = 0; q < k; ++q) s.skey[(size_t)q * W + best] = akey[(size_t)q * astride];
        s.sseq[best] = s.nx;
        s.ssrc[best] = asrc;
        s.nan_slots += anan - s.snan[best];
        s.snan[best] = anan;
      }
    }
  } else if (lane == 0) {
    while (s.socc[s.first_free]) ++s.first_free;  // slots only ever fill
    for (int q = 0; q < k; ++q) s.skey[(size_t)q * W + s.first_free] = akey[(size_t)q * astride];
    s.sseq[s.first_free] = s.nx;
    s.ssrc[s.first_free] = asrc;
    s.socc[s.first_free] = 1;
    s.snan[s.first_free] = anan;
    s.nan_slots += anan;
    ++s.occ_count;
  }
  o.n = __shfl_sync(kFull, o.n, 0);
  o.ovf = __shfl_sync(kFull, (int)o.ovf, 0) != 0;
  s.occ_count = __shfl_sync(kFull, s.occ_count, 0);
  s.nan_slots = __shfl_sync(kFull, s.nan_slots, 0);
  __syncwarp();
  ++s.nx;
}

// NK > 0: the comparator has NK keys (the candidates' keys live in
// registers); NK == 0: K.k keys, up to kMaxSortKeys. Warp 0 walks the rows.
template <int NK>
__global__ void sort_kernel(int B, int W, SortKeys K, const bool* valid, const int8_t* kind,
                            const int64_t* ts, const bool* occ, const int64_t* seq,
                            const int64_t* next, const int64_t* now, char* gslots,
                            int slots_in_smem, int32_t* out_src, int64_t* out_ts,
                            int8_t* out_kind, bool* out_valid, int32_t* new_src, bool* new_occ,
                            int64_t* new_seq, int64_t* new_next, bool* ovf) {
  extern __shared__ __align__(16) char smem[];
  const int k = NK > 0 ? NK : K.k;
  // tile lanes: keys [k][kTile], ts, flags, "a float key is NaN"
  Key* tkey = (Key*)smem;
  long long* tts = (long long*)(tkey + (size_t)k * kTile);
  unsigned char* tflag = (unsigned char*)(tts + kTile);
  unsigned char* tnan = tflag + kTile;
  char* sbase = slots_in_smem ? (char*)(tnan + kTile) : gslots;
  sbase = (char*)(((uintptr_t)sbase + 15) & ~(uintptr_t)15);

  Out o{out_src, out_ts, out_kind, out_valid, 2 * B, 0, false};
  clear_out(o);
  SortSlots s;
  sort_slots_load(s, sbase, K, k, W, 0, occ, seq, *next, 0, threadIdx.x, blockDim.x);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long t_now = *now;
  if (threadIdx.x < 32) sort_slots_count(s, lane);
  for (int base = 0; base < B; base += kTile) {
    const int rows = B - base < kTile ? B - base : kTile;
    __syncthreads();
    for (int t = threadIdx.x; t < rows; t += blockDim.x) {
      const int r = base + t;
      tflag[t] = (unsigned char)row_flags(valid, kind, r);
      tts[t] = ts[r];
      unsigned char nan = 0;
      for (int q = 0; q < k; ++q) {
        const Key v = load_key(K.batch[q], r, K.type[q], K.desc[q]);
        tkey[(size_t)q * kTile + t] = v;
        nan |= K.type[q] == 0 && isnan(v.f);
      }
      tnan[t] = nan;
    }
    __syncthreads();
    if (threadIdx.x >= 32) continue;
    for (int t = 0; t < rows; ++t) {
      if (tflag[t] != 1) continue;  // only CURRENT rows enter the window
      sort_arrive<NK>(K, k, s, o, tkey + t, kTile, tnan[t], tts[t], W + base + t, t_now);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    new_src[j] = s.ssrc[j];
    new_occ[j] = s.socc[j] != 0;
    new_seq[j] = s.sseq[j];
  }
  if (threadIdx.x == 0) {
    *new_next = s.nx;
    *ovf = o.ovf;
  }
}

// K40: the sort window of every partition at once. A warp a slot walks the
// slot's member rows (rowlist[slot_start[p]..slot_start[p + 1]), in row
// order) with `sort_arrive`, its slot lanes in its own stretch of the
// global scratch (slot_bytes each), its emissions into its own stretch of
// the output (2 * slot_start[p], two rows a member row at most); a source
// is state element p*W + j or batch row P*W + r. n_slot[p] = the slot's
// emitted rows; a slot without rows keeps its state.
template <int NK>
__global__ void psort_kernel(int W, int P, SortKeys K, int slot_bytes, const int64_t* ts,
                             const int32_t* rowlist, const int32_t* slot_start, const bool* occ,
                             const int64_t* seq, const int64_t* next, const int64_t* now,
                             char* gslots, int32_t* out_src, int64_t* out_ts, int8_t* out_kind,
                             bool* out_valid, int32_t* n_slot, int32_t* new_src, bool* new_occ,
                             int64_t* new_seq, int64_t* new_next, bool* ovf) {
  constexpr int kKeys = NK > 0 ? NK : kMaxSortKeys;
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= P) return;
  const int k = NK > 0 ? NK : K.k;
  const int lane = threadIdx.x & 31;
  const long long off = (long long)p * W;
  const int lo = slot_start[p], hi = slot_start[p + 1];
  SortSlots s;
  sort_slots_load(s, gslots + (size_t)p * slot_bytes, K, k, W, off, occ, seq, next[p],
                  (int)off, lane, 32);
  __syncwarp();
  sort_slots_count(s, lane);
  Out o{out_src + 2 * lo, out_ts + 2 * lo, out_kind + 2 * lo, out_valid + 2 * lo,
        2 * (hi - lo), 0, false};
  const long long t_now = *now;
  for (int i = lo; i < hi; ++i) {
    const int r = rowlist[i];
    Key ak[kKeys];
    unsigned char anan = 0;
#pragma unroll
    for (int q = 0; q < kKeys; ++q) {
      if (q < k) {
        ak[q] = load_key(K.batch[q], r, K.type[q], K.desc[q]);
        anan |= K.type[q] == 0 && isnan(ak[q].f);
      }
    }
    sort_arrive<NK>(K, k, s, o, ak, 1, anan, ts[r], P * W + r, t_now);
  }
  for (int j = lane; j < W; j += 32) {
    new_src[off + j] = s.ssrc[j];
    new_occ[off + j] = s.socc[j] != 0;
    new_seq[off + j] = s.sseq[j];
  }
  if (lane == 0) {
    new_next[p] = s.nx;
    n_slot[p] = o.n;
    if (o.ovf) *ovf = true;
  }
}

// ---------------------------------------------------------------------------
// K26 / K27: frequent (Misra-Gries) and lossyFrequent (lossy counting)
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// First slot in [0, W) where `pred` holds, found by one warp's ballots (-1 if none).
template <typename Pred>
__device__ __forceinline__ int warp_first(int W, Pred pred) {
  const int lane = threadIdx.x & 31;
  for (int b = 0; b < W; b += 32) {
    const int s = b + lane;
    const unsigned m = __ballot_sync(kFull, s < W && pred(s));
    if (m) return b + __ffs(m) - 1;
  }
  return -1;
}

// Append, in slot order, every slot where `pred` holds (each as src[s] with
// ts `t` and kind `kd`), then run `after(s)` on those slots: one warp.
template <typename Pred, typename After>
__device__ __forceinline__ int warp_emit(Out& o, int W, const int* ssrc, long long t, int8_t kd,
                                         Pred pred, After after) {
  const int lane = threadIdx.x & 31;
  int total = 0;
  for (int b = 0; b < W; b += 32) {
    const int s = b + lane;
    const bool p = s < W && pred(s);
    const unsigned m = __ballot_sync(kFull, p);
    if (p) {
      const int pos = o.n + __popc(m & lanes_below());
      if (pos < o.cap) {
        o.src[pos] = ssrc[s];
        o.ts[pos] = t;
        o.kind[pos] = kd;
        o.valid[pos] = true;
      }
      after(s);
    }
    const int c = __popc(m);
    if (o.n + c > o.cap) o.ovf = true;
    o.n = o.n + c < o.cap ? o.n + c : o.cap;
    total += c;
  }
  __syncwarp();
  return total;
}

// The slot lanes of one frequent window as its walk sees them: keys,
// counts, sources and occupied flags, and the occupied count.
struct FreqSlots {
  long long* skey;
  int* scnt;
  int* ssrc;
  unsigned char* socc;
  int W;
  int occ_count;
};

// Point s at its lanes in `base` (16-byte aligned) and load them from a
// window's state at element off: slot j's source is src0 + j.
__device__ __forceinline__ void freq_slots_load(FreqSlots& s, char* base, int W, long long off,
                                                const bool* occ, const int64_t* skey_in,
                                                const int32_t* cnt, int src0, int lane,
                                                int stride) {
  s.skey = (long long*)base;
  s.scnt = (int*)(s.skey + W);
  s.ssrc = s.scnt + W;
  s.socc = (unsigned char*)(s.ssrc + W);
  s.W = W;
  for (int j = lane; j < W; j += stride) {
    s.skey[j] = skey_in[off + j];
    s.scnt[j] = cnt[off + j];
    s.ssrc[j] = src0 + j;
    s.socc[j] = occ[off + j] ? 1 : 0;
  }
}

__device__ __forceinline__ void freq_slots_count(FreqSlots& s, int lane) {
  int occ_count = 0;
  for (int j = lane; j < s.W; j += 32) occ_count += s.socc[j];
  for (int d = 16; d > 0; d >>= 1) occ_count += __shfl_xor_sync(kFull, occ_count, d);
  s.occ_count = occ_count;
}

// One CURRENT arrival with key kk through a frequent window
// (windows_special.py's scan body): its slot is the first occupied slot
// holding kk; a new key with the table full first drops every count by
// one, the zeros leaving as EXPIRED rows at t_now in slot order; then a
// new key takes the first free slot, or is dropped if none is free. A kept
// arrival leaves as a CURRENT row (source asrc). Every lane of one warp
// calls it.
__device__ __forceinline__ void frequent_arrive(FreqSlots& s, Out& o, long long kk, long long ats,
                                                int asrc, long long t_now) {
  const int lane = threadIdx.x & 31;
  const int W = s.W;
  int slot = warp_first(W, [&](int j) { return s.socc[j] && s.skey[j] == kk; });
  const bool exists = slot >= 0;
  bool insert = false;
  if (!exists) {
    if (s.occ_count == W) {
      s.occ_count -= warp_emit(o, W, s.ssrc, t_now, kExpired,
                               [&](int j) {
                                 if (!s.socc[j]) return false;
                                 return --s.scnt[j] == 0;
                               },
                               [&](int j) { s.socc[j] = 0; });
    }
    if (s.occ_count < W) {
      slot = warp_first(W, [&](int j) { return !s.socc[j]; });
      insert = true;
    }
  }
  if (exists || insert) {
    if (lane == 0) {
      o.append(asrc, ats, kCurrent);
      s.ssrc[slot] = asrc;
      s.socc[slot] = 1;
      s.skey[slot] = kk;
      s.scnt[slot] = exists ? s.scnt[slot] + 1 : 1;
    }
    o.n = __shfl_sync(kFull, o.n, 0);
    o.ovf = __shfl_sync(kFull, (int)o.ovf, 0) != 0;
    if (insert) ++s.occ_count;
    __syncwarp();
  }
}

__global__ void frequent_kernel(int B, int W, const bool* valid, const int8_t* kind,
                                const int64_t* ts, const int64_t* key, const bool* occ,
                                const int64_t* skey_in, const int32_t* cnt, const int64_t* now,
                                char* gslots, int slots_in_smem, int32_t* out_src,
                                int64_t* out_ts, int8_t* out_kind, bool* out_valid,
                                int32_t* new_src, bool* new_occ, int64_t* new_key,
                                int32_t* new_cnt, bool* ovf) {
  extern __shared__ __align__(16) char smem[];
  long long* tkey = (long long*)smem;
  long long* tts = tkey + kTile;
  unsigned char* tflag = (unsigned char*)(tts + kTile);
  char* sbase = slots_in_smem ? (char*)(tflag + kTile) : gslots;
  sbase = (char*)(((uintptr_t)sbase + 15) & ~(uintptr_t)15);

  Out o{out_src, out_ts, out_kind, out_valid, 2 * B + W, 0, false};
  clear_out(o);
  FreqSlots s;
  freq_slots_load(s, sbase, W, 0, occ, skey_in, cnt, 0, threadIdx.x, blockDim.x);
  __syncthreads();
  const long long t_now = *now;
  if (threadIdx.x < 32) freq_slots_count(s, threadIdx.x & 31);
  for (int base = 0; base < B; base += kTile) {
    const int rows = B - base < kTile ? B - base : kTile;
    __syncthreads();
    for (int t = threadIdx.x; t < rows; t += blockDim.x) {
      const int r = base + t;
      tflag[t] = (unsigned char)row_flags(valid, kind, r);
      tts[t] = ts[r];
      tkey[t] = key[r];
    }
    __syncthreads();
    if (threadIdx.x >= 32) continue;
    for (int t = 0; t < rows; ++t) {
      if (tflag[t] != 1) continue;
      frequent_arrive(s, o, tkey[t], tts[t], W + base + t, t_now);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    new_src[j] = s.ssrc[j];
    new_occ[j] = s.socc[j] != 0;
    new_key[j] = s.skey[j];
    new_cnt[j] = s.scnt[j];
  }
  if (threadIdx.x == 0) *ovf = o.ovf;
}

// K41: the frequent window of every partition at once, as psort_kernel:
// a warp a slot with `frequent_arrive`, its emissions into its stretch at
// 2 * slot_start[p] + p * W (its member rows' CURRENT rows and at most W
// plus one a row of evictions: 2 * rows + W).
__global__ void pfrequent_kernel(int W, int P, int slot_bytes, const int64_t* ts,
                                 const int64_t* key, const int32_t* rowlist,
                                 const int32_t* slot_start, const bool* occ,
                                 const int64_t* skey_in, const int32_t* cnt, const int64_t* now,
                                 char* gslots, int32_t* out_src, int64_t* out_ts,
                                 int8_t* out_kind, bool* out_valid, int32_t* n_slot,
                                 int32_t* new_src, bool* new_occ, int64_t* new_key,
                                 int32_t* new_cnt, bool* ovf) {
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= P) return;
  const int lane = threadIdx.x & 31;
  const long long off = (long long)p * W;
  const int lo = slot_start[p], hi = slot_start[p + 1];
  FreqSlots s;
  freq_slots_load(s, gslots + (size_t)p * slot_bytes, W, off, occ, skey_in, cnt, (int)off, lane,
                  32);
  __syncwarp();
  freq_slots_count(s, lane);
  const long long o0 = 2LL * lo + off;
  Out o{out_src + o0, out_ts + o0, out_kind + o0, out_valid + o0, 2 * (hi - lo) + W, 0, false};
  const long long t_now = *now;
  for (int i = lo; i < hi; ++i) {
    const int r = rowlist[i];
    frequent_arrive(s, o, key[r], ts[r], P * W + r, t_now);
  }
  for (int j = lane; j < W; j += 32) {
    new_src[off + j] = s.ssrc[j];
    new_occ[off + j] = s.socc[j] != 0;
    new_key[off + j] = s.skey[j];
    new_cnt[off + j] = s.scnt[j];
  }
  if (lane == 0) {
    n_slot[p] = o.n;
    if (o.ovf) *ovf = true;
  }
}

// The slot lanes of one lossyFrequent window as its walk sees them: keys,
// counts, buckets, sources and occupied flags, the occupied count and the
// window's own total.
struct LossySlots {
  long long* skey;
  long long* scnt;
  long long* sbkt;
  int* ssrc;
  unsigned char* socc;
  int C;
  int occ_count;
  long long total;
};

// Point s at its lanes in `base` (16-byte aligned) and load them from a
// window's state at element off: slot j's source is src0 + j.
__device__ __forceinline__ void lossy_slots_load(LossySlots& s, char* base, int C, long long off,
                                                 const bool* occ, const int64_t* skey_in,
                                                 const int64_t* cnt, const int64_t* bucket,
                                                 long long total, int src0, int lane,
                                                 int stride) {
  s.skey = (long long*)base;
  s.scnt = s.skey + C;
  s.sbkt = s.scnt + C;
  s.ssrc = (int*)(s.sbkt + C);
  s.socc = (unsigned char*)(s.ssrc + C);
  s.C = C;
  s.total = total;
  for (int j = lane; j < C; j += stride) {
    s.skey[j] = skey_in[off + j];
    s.scnt[j] = cnt[off + j];
    s.sbkt[j] = bucket[off + j];
    s.ssrc[j] = src0 + j;
    s.socc[j] = occ[off + j] ? 1 : 0;
  }
}

__device__ __forceinline__ void lossy_slots_count(LossySlots& s, int lane) {
  int occ_count = 0;
  for (int j = lane; j < s.C; j += 32) occ_count += s.socc[j];
  for (int d = 16; d > 0; d >>= 1) occ_count += __shfl_xor_sync(kFull, occ_count, d);
  s.occ_count = occ_count;
}

// One CURRENT arrival with key kk through a lossyFrequent window
// (windows_special.py's scan body): the total grows by one; the key's slot
// is the first occupied slot holding it, else the first free slot (its
// bucket the current one less one), else the row is lost (flag set); a
// kept arrival whose count meets (s - e) * total leaves as a CURRENT row
// (source asrc); at each bucket boundary the slots with cnt + bucket <=
// the current bucket leave as EXPIRED rows at t_now, in slot order. Every
// lane of one warp calls it.
__device__ __forceinline__ void lossy_arrive(LossySlots& s, Out& o, long long kk, long long ats,
                                             int asrc, long long t_now, long long width,
                                             float support_minus_error) {
  const int lane = threadIdx.x & 31;
  const int C = s.C;
  const long long total = ++s.total;
  const long long cur_bucket = total <= 1 ? 1 : (total + width - 1) / width;
  int slot = warp_first(C, [&](int j) { return s.socc[j] && s.skey[j] == kk; });
  const bool exists = slot >= 0;
  bool insert = false;
  if (!exists) {
    if (s.occ_count < C) {
      slot = warp_first(C, [&](int j) { return !s.socc[j]; });
      insert = true;
    } else {
      o.ovf = true;  // no slot for a new key: the row is lost
    }
  }
  if (exists || insert) {
    if (lane == 0) {
      s.scnt[slot] = exists ? s.scnt[slot] + 1 : 1;
      if (insert) s.sbkt[slot] = cur_bucket - 1;
      s.socc[slot] = 1;
      s.skey[slot] = kk;
      s.ssrc[slot] = asrc;
      // (s - e) * total in float32, as the JAX package multiplies a
      // float32 total by the weakly typed (s - e): no contraction
      const float need = __fmul_rn(support_minus_error, __ll2float_rn(total));
      if (__ll2float_rn(s.scnt[slot]) >= need) o.append(asrc, ats, kCurrent);
    }
    o.n = __shfl_sync(kFull, o.n, 0);
    o.ovf = __shfl_sync(kFull, (int)o.ovf, 0) != 0;
    if (insert) ++s.occ_count;
    __syncwarp();
  }
  if (total % width == 0) {
    // bucket boundary: prune cnt + bucket <= cur_bucket, in slot order
    s.occ_count -= warp_emit(
        o, C, s.ssrc, t_now, kExpired,
        [&](int j) { return s.socc[j] && s.scnt[j] + s.sbkt[j] <= cur_bucket; },
        [&](int j) { s.socc[j] = 0; });
  }
}

__device__ __forceinline__ void lossy_slots_store(const LossySlots& s, long long off, int lane,
                                                  int stride, int32_t* new_src, bool* new_occ,
                                                  int64_t* new_key, int64_t* new_cnt,
                                                  int64_t* new_bucket) {
  for (int j = lane; j < s.C; j += stride) {
    new_src[off + j] = s.ssrc[j];
    new_occ[off + j] = s.socc[j] != 0;
    new_key[off + j] = s.skey[j];
    new_cnt[off + j] = s.scnt[j];
    new_bucket[off + j] = s.sbkt[j];
  }
}

__global__ void lossy_kernel(int B, int C, long long width, float support_minus_error,
                             const bool* valid, const int8_t* kind, const int64_t* ts,
                             const int64_t* key, const bool* occ, const int64_t* skey_in,
                             const int64_t* cnt, const int64_t* bucket, const int64_t* total_in,
                             const int64_t* now, char* gslots, int slots_in_smem,
                             int32_t* out_src, int64_t* out_ts, int8_t* out_kind, bool* out_valid,
                             int32_t* new_src, bool* new_occ, int64_t* new_key, int64_t* new_cnt,
                             int64_t* new_bucket, int64_t* new_total, bool* ovf) {
  extern __shared__ __align__(16) char smem[];
  long long* tkey = (long long*)smem;
  long long* tts = tkey + kTile;
  unsigned char* tflag = (unsigned char*)(tts + kTile);
  char* sbase = slots_in_smem ? (char*)(tflag + kTile) : gslots;
  sbase = (char*)(((uintptr_t)sbase + 15) & ~(uintptr_t)15);

  Out o{out_src, out_ts, out_kind, out_valid, B + C, 0, false};
  clear_out(o);
  LossySlots s;
  lossy_slots_load(s, sbase, C, 0, occ, skey_in, cnt, bucket, *total_in, 0, threadIdx.x,
                   blockDim.x);
  __syncthreads();
  const long long t_now = *now;
  if (threadIdx.x < 32) lossy_slots_count(s, threadIdx.x & 31);
  for (int base = 0; base < B; base += kTile) {
    const int rows = B - base < kTile ? B - base : kTile;
    __syncthreads();
    for (int t = threadIdx.x; t < rows; t += blockDim.x) {
      const int r = base + t;
      tflag[t] = (unsigned char)row_flags(valid, kind, r);
      tts[t] = ts[r];
      tkey[t] = key[r];
    }
    __syncthreads();
    if (threadIdx.x >= 32) continue;
    for (int t = 0; t < rows; ++t) {
      if (tflag[t] != 1) continue;
      lossy_arrive(s, o, tkey[t], tts[t], C + base + t, t_now, width, support_minus_error);
    }
  }
  __syncthreads();
  lossy_slots_store(s, 0, threadIdx.x, blockDim.x, new_src, new_occ, new_key, new_cnt,
                    new_bucket);
  if (threadIdx.x == 0) {
    *new_total = s.total;
    *ovf = o.ovf;
  }
}

// K42: the lossyFrequent window of every partition at once, as
// pfrequent_kernel: a warp a slot with `lossy_arrive` and the slot's own
// total; its key table in shared memory when kSlotWarps of them fit
// (slots_in_smem), else in its stretch of the global scratch; its
// emissions into its stretch at 2 * slot_start[p] + p * C (its CURRENT
// rows and at most C + rows pruned: 2 * rows + C), capped at B + C as the
// JAX package's per-partition buffer is.
__global__ void plossy_kernel(int B, int C, int P, long long width, float support_minus_error,
                              int slot_bytes, int slots_in_smem, const int64_t* ts,
                              const int64_t* key, const int32_t* rowlist,
                              const int32_t* slot_start, const bool* occ,
                              const int64_t* skey_in, const int64_t* cnt, const int64_t* bucket,
                              const int64_t* total_in, const int64_t* now, char* gslots,
                              int32_t* out_src, int64_t* out_ts, int8_t* out_kind,
                              bool* out_valid, int32_t* n_slot, int32_t* new_src, bool* new_occ,
                              int64_t* new_key, int64_t* new_cnt, int64_t* new_bucket,
                              int64_t* new_total, bool* ovf) {
  extern __shared__ __align__(16) char smem[];
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= P) return;
  const int lane = threadIdx.x & 31;
  const long long off = (long long)p * C;
  const int lo = slot_start[p], hi = slot_start[p + 1];
  char* base = slots_in_smem ? smem + (size_t)warp * slot_bytes : gslots + (size_t)p * slot_bytes;
  LossySlots s;
  lossy_slots_load(s, base, C, off, occ, skey_in, cnt, bucket, total_in[p], (int)off, lane, 32);
  __syncwarp();
  lossy_slots_count(s, lane);
  const long long o0 = 2LL * lo + off;
  const int stretch = 2 * (hi - lo) + C;
  Out o{out_src + o0, out_ts + o0, out_kind + o0, out_valid + o0,
        stretch < B + C ? stretch : B + C, 0, false};
  const long long t_now = *now;
  for (int i = lo; i < hi; ++i) {
    const int r = rowlist[i];
    lossy_arrive(s, o, key[r], ts[r], P * C + r, t_now, width, support_minus_error);
  }
  lossy_slots_store(s, off, lane, 32, new_src, new_occ, new_key, new_cnt, new_bucket);
  if (lane == 0) {
    new_total[p] = s.total;
    n_slot[p] = o.n;
    if (o.ovf) *ovf = true;
  }
}

// ---------------------------------------------------------------------------
// K28: cron
// ---------------------------------------------------------------------------

// The src index space: [open buckets (n0) | previous buckets (n1) | batch
// rows]: n0 = n1 = W for one window, P * W for every partition's.
struct CronSrc {
  const int64_t* cur_ts;
  const int64_t* prev_ts;
  const int64_t* ts;
  long long n0, n1;

  __device__ __forceinline__ long long ts_of(int s) const {
    return s < 0 ? 0 : s < n0 ? cur_ts[s] : s < n0 + n1 ? prev_ts[s - n0] : ts[s - n0 - n1];
  }
};

// One cron window's buffers as its walk sees them: the sources of the open
// bucket's and the previous bucket's W slots (bufs[cur] the open one) and
// their counts.
struct CronSlot {
  int* bufs[2];
  int cur;
  int cur_n;
  int prev_n;
  int W;
};

// Append k rows in order (row i: source src_of(i), ts ts_of(i), kind kd)
// by the lanes of one warp; rows past the capacity are dropped and set the
// flag, as k calls of Out::append would.
template <typename S, typename T>
__device__ __forceinline__ void warp_append_n(Out& o, int k, int8_t kd, S src_of, T ts_of) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < k; i += 32) {
    const int pos = o.n + i;
    if (pos < o.cap) {
      o.src[pos] = src_of(i);
      o.ts[pos] = ts_of(i);
      o.kind[pos] = kd;
      o.valid[pos] = true;
    }
  }
  if (o.n + k > o.cap) o.ovf = true;
  o.n = o.n + k < o.cap ? o.n + k : o.cap;
  __syncwarp();
}

// One row through a cron window (windows_special.py's scan body), by every
// lane of one warp: a TIMER row (flag 2) with a non-empty open bucket
// flushes it (the previous bucket EXPIRED at t_now, one RESET from the
// previous bucket's slot 0, the bucket CURRENT with its rows' own ts; the
// bucket becomes the previous one and the open bucket empties); a CURRENT
// row (flag 1) joins the open bucket as source row_src, or is lost with
// the flag set when the bucket is full.
__device__ __forceinline__ void cron_row(CronSlot& s, Out& o, int flag, int row_src,
                                         long long t_now, const CronSrc& src) {
  const int lane = threadIdx.x & 31;
  if (flag == 2 && s.cur_n > 0) {
    const int* pv = s.bufs[s.cur ^ 1];
    const int* cv = s.bufs[s.cur];
    warp_append_n(o, s.prev_n, kExpired, [&](int j) { return pv[j]; },
                  [&](int) { return t_now; });
    const int r0 = pv[0];
    warp_append_n(o, 1, kReset, [&](int) { return r0; }, [&](int) { return t_now; });
    warp_append_n(o, s.cur_n, kCurrent, [&](int j) { return cv[j]; },
                  [&](int j) { return src.ts_of(cv[j]); });
    s.cur ^= 1;  // the bucket becomes the previous one; the new bucket is zeros
    int* fresh = s.bufs[s.cur];
    for (int j = lane; j < s.W; j += 32) fresh[j] = -1;
    __syncwarp();
    s.prev_n = s.cur_n;
    s.cur_n = 0;
  } else if (flag == 1) {
    if (s.cur_n < s.W) {
      if (lane == 0) s.bufs[s.cur][s.cur_n] = row_src;
      ++s.cur_n;
      __syncwarp();
    } else {
      o.ovf = true;
    }
  }
}

__global__ void cron_kernel(int B, int W, const bool* valid, const int8_t* kind,
                            const int64_t* ts, const int64_t* cur_ts, const int32_t* cur_n_in,
                            const int64_t* prev_ts, const int32_t* prev_n_in, const int64_t* now,
                            int32_t* gslots, int slots_in_smem, int32_t* out_src,
                            int64_t* out_ts, int8_t* out_kind, bool* out_valid,
                            int32_t* new_cur_src, int32_t* new_prev_src, int32_t* new_cur_n,
                            int32_t* new_prev_n, bool* ovf) {
  extern __shared__ __align__(16) char smem[];
  unsigned char* tflag = (unsigned char*)smem;
  int* sl = slots_in_smem ? (int*)(smem + kTile) : gslots;

  Out o{out_src, out_ts, out_kind, out_valid, B + 2 * (2 * W + 1), 0, false};
  clear_out(o);
  CronSlot s{{sl, sl + W}, 0, *cur_n_in, *prev_n_in, W};
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    s.bufs[0][j] = j;
    s.bufs[1][j] = W + j;
  }
  __syncthreads();
  const CronSrc src{cur_ts, prev_ts, ts, W, W};
  const long long t_now = *now;
  for (int base = 0; base < B; base += kTile) {
    const int rows = B - base < kTile ? B - base : kTile;
    __syncthreads();
    for (int t = threadIdx.x; t < rows; t += blockDim.x) {
      tflag[t] = (unsigned char)row_flags(valid, kind, base + t);
    }
    __syncthreads();
    if (threadIdx.x >= 32) continue;  // warp 0 walks the rows
    for (int t = 0; t < rows; ++t) cron_row(s, o, tflag[t], 2 * W + base + t, t_now, src);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // publish which buffer ended as the open bucket
    tflag[0] = (unsigned char)s.cur;
  }
  __syncthreads();
  const int c = tflag[0];
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    new_cur_src[j] = s.bufs[c][j];
    new_prev_src[j] = s.bufs[c ^ 1][j];
  }
  if (threadIdx.x == 0) {
    *new_cur_n = s.cur_n;
    *new_prev_n = s.prev_n;
    *ovf = o.ovf;
  }
}

// K43: the cron window of every partition at once. A warp a slot walks the
// slot's member rows merged with the batch's TIMER rows (every slot sees
// each TIMER row), in row order, with `cron_row`; its buffers in its
// stretch of the global scratch (2 * W sources); its emissions into its
// stretch at off[p], cap[p] rows (the wrapper's bound: at most one flush
// of 2W + 1 rows a TIMER row, and only while a row has arrived since the
// last, capped at B + 2(2W + 1) as the JAX package's per-partition
// buffer). A source is open-bucket element p*W + j, previous-bucket element
// P*W + p*W + j or batch row 2*P*W + r. A slot with neither member nor
// TIMER rows keeps its state.
__global__ void pcron_kernel(int W, int P, const int64_t* ts, const int32_t* rowlist,
                             const int32_t* slot_start, const int32_t* timers,
                             const int32_t* info, const int64_t* cur_ts,
                             const int32_t* cur_n_in, const int64_t* prev_ts,
                             const int32_t* prev_n_in, const int64_t* now, const int64_t* off,
                             const int32_t* cap, int32_t* gslots, int32_t* out_src,
                             int64_t* out_ts, int8_t* out_kind, bool* out_valid, int32_t* n_slot,
                             int32_t* new_cur_src, int32_t* new_prev_src, int32_t* new_cur_n,
                             int32_t* new_prev_n, bool* ovf) {
  const int p = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (p >= P) return;
  const int lane = threadIdx.x & 31;
  const long long pw = (long long)P * W, e0 = (long long)p * W;
  int* sl = gslots + 2 * e0;
  CronSlot s{{sl, sl + W}, 0, cur_n_in[p], prev_n_in[p], W};
  for (int j = lane; j < W; j += 32) {
    s.bufs[0][j] = (int)(e0 + j);
    s.bufs[1][j] = (int)(pw + e0 + j);
  }
  __syncwarp();
  const CronSrc src{cur_ts, prev_ts, ts, pw, pw};
  const long long o0 = off[p];
  Out o{out_src + o0, out_ts + o0, out_kind + o0, out_valid + o0, cap[p], 0, false};
  const long long t_now = *now;
  const int lo = slot_start[p], hi = slot_start[p + 1], nt = info[3];
  int i = lo, k = 0;
  while (i < hi || k < nt) {
    // the next row of the merged lists (a row is a member or a TIMER row)
    const bool member = k >= nt || (i < hi && rowlist[i] < timers[k]);
    const int r = member ? rowlist[i++] : timers[k++];
    cron_row(s, o, member ? 1 : 2, (int)(2 * pw + r), t_now, src);
  }
  for (int j = lane; j < W; j += 32) {
    new_cur_src[e0 + j] = s.bufs[s.cur][j];
    new_prev_src[e0 + j] = s.bufs[s.cur ^ 1][j];
  }
  if (lane == 0) {
    new_cur_n[p] = s.cur_n;
    new_prev_n[p] = s.prev_n;
    n_slot[p] = o.n;
    if (o.ovf) *ovf = true;
  }
}

// ---------------------------------------------------------------------------
// the column gather
// ---------------------------------------------------------------------------

constexpr int kMaxLanes = 16;

struct Lanes {
  const void* s0[kMaxLanes];
  const void* s1[kMaxLanes];
  const void* s2[kMaxLanes];
  void* out[kMaxLanes];
  int size[kMaxLanes];
};

// out[i] = m < 0 ? 0 : m < n0 ? s0[m] : m < n0 + n1 ? s1[m - n0] : s2[m - n0 - n1]
template <typename T>
__device__ __forceinline__ void gather_elem(const Lanes& L, int l, int i, int m, int n0, int n1) {
  T v = 0;
  if (m >= 0) {
    v = m < n0 ? ((const T*)L.s0[l])[m]
        : m < n0 + n1 ? ((const T*)L.s1[l])[m - n0]
                      : ((const T*)L.s2[l])[m - n0 - n1];
  }
  ((T*)L.out[l])[i] = v;
}

__global__ void gather_kernel(Lanes L, const int32_t* idx, int rows, int n0, int n1) {
  const int l = blockIdx.y;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < rows; i += gridDim.x * blockDim.x) {
    const int m = idx[i];
    switch (L.size[l]) {
      case 1: gather_elem<uint8_t>(L, l, i, m, n0, n1); break;
      case 4: gather_elem<uint32_t>(L, l, i, m, n0, n1); break;
      default: gather_elem<unsigned long long>(L, l, i, m, n0, n1); break;
    }
  }
}

int max_smem() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// Dynamic shared memory for `tile` bytes of row lanes plus `slots` bytes of
// slot lanes when both fit (then *in_smem = 1), else the tile alone.
template <typename F>
int smem_for(F kernel, size_t tile, size_t slots, int* in_smem) {
  const size_t both = tile + 16 + slots;
  const int cap = max_smem();
  *in_smem = both <= (size_t)cap ? 1 : 0;
  const size_t bytes = *in_smem ? both : tile;
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return -1;
  }
  return (int)bytes;
}

// Bytes of each step's slot lanes, in shared memory or else in the global
// scratch the wrapper allocates (sized by sw_slot_bytes).
long long sw_sort_slot_bytes(int W, int k) {
  return (long long)k * W * 8 + (long long)W * 8 + (long long)W * 4 + 2LL * W + 16;
}
long long sw_frequent_slot_bytes(int W) { return (long long)W * 17 + 16; }
long long sw_lossy_slot_bytes(int C) { return (long long)C * 29 + 16; }
long long sw_cron_slot_bytes(int W) { return (long long)W * 8 + 16; }

}  // namespace

extern "C" {

// The global scratch a step needs for its slot lanes (0 sort with k keys,
// 1 frequent, 2 lossyFrequent, 3 cron; W slots); 4: a K42 slot's lanes
// (16-byte aligned) when kSlotWarps of them do not fit in a block's shared
// memory, else 0 (no scratch: they live in shared memory).
int sw_slot_bytes(int which, int W, int k) {
  if (which == 4) {
    const long long b = (sw_lossy_slot_bytes(W) + 15) / 16 * 16;
    return kSlotWarps * b <= max_smem() ? 0 : (int)b;
  }
  const long long b = which == 0 ? sw_sort_slot_bytes(W, k)
                      : which == 1 ? sw_frequent_slot_bytes(W)
                      : which == 2 ? sw_lossy_slot_bytes(W)
                                   : sw_cron_slot_bytes(W);
  return (int)b;
}

int sw_sort(int B, int W, int k, const void* const* state_keys, const void* const* batch_keys,
            const int* types, const int* desc, const void* valid, const void* kind,
            const void* ts, const void* occ, const void* seq, const void* next, const void* now,
            void* scratch, void* out_src, void* out_ts, void* out_kind, void* out_valid,
            void* new_src, void* new_occ, void* new_seq, void* new_next, void* ovf,
            cudaStream_t stream) {
  if (k < 1 || k > kMaxSortKeys) return (int)cudaErrorInvalidValue;
  SortKeys K;
  K.k = k;
  for (int q = 0; q < k; ++q) {
    K.state[q] = state_keys[q];
    K.batch[q] = batch_keys[q];
    K.type[q] = types[q];
    K.desc[q] = desc[q];
  }
  auto kernel = k == 1 ? sort_kernel<1> : k == 2 ? sort_kernel<2> : k == 3 ? sort_kernel<3>
                                                                     : sort_kernel<0>;
  int in_smem = 0;
  const size_t tile = (size_t)k * kTile * 8 + kTile * 8 + 2 * kTile;
  const int bytes = smem_for(kernel, tile, (size_t)sw_sort_slot_bytes(W, k), &in_smem);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  kernel<<<1, kThreads, bytes, stream>>>(
      B, W, K, (const bool*)valid, (const int8_t*)kind, (const int64_t*)ts, (const bool*)occ,
      (const int64_t*)seq, (const int64_t*)next, (const int64_t*)now, (char*)scratch, in_smem,
      (int32_t*)out_src, (int64_t*)out_ts, (int8_t*)out_kind, (bool*)out_valid,
      (int32_t*)new_src, (bool*)new_occ, (int64_t*)new_seq, (int64_t*)new_next, (bool*)ovf);
  return (int)cudaGetLastError();
}

int sw_frequent(int B, int W, const void* valid, const void* kind, const void* ts,
                const void* key, const void* occ, const void* skey, const void* cnt,
                const void* now, void* scratch, void* out_src, void* out_ts, void* out_kind,
                void* out_valid, void* new_src, void* new_occ, void* new_key, void* new_cnt,
                void* ovf, cudaStream_t stream) {
  int in_smem = 0;
  const size_t tile = (size_t)kTile * 17;
  const int bytes = smem_for(frequent_kernel, tile, (size_t)sw_frequent_slot_bytes(W), &in_smem);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  frequent_kernel<<<1, kThreads, bytes, stream>>>(
      B, W, (const bool*)valid, (const int8_t*)kind, (const int64_t*)ts, (const int64_t*)key,
      (const bool*)occ, (const int64_t*)skey, (const int32_t*)cnt, (const int64_t*)now,
      (char*)scratch, in_smem, (int32_t*)out_src, (int64_t*)out_ts, (int8_t*)out_kind,
      (bool*)out_valid, (int32_t*)new_src, (bool*)new_occ, (int64_t*)new_key,
      (int32_t*)new_cnt, (bool*)ovf);
  return (int)cudaGetLastError();
}

int sw_psort(int B, int W, int P, int k, int slot_bytes, const void* const* state_keys,
             const void* const* batch_keys, const int* types, const int* desc, const void* ts,
             const void* rowlist, const void* slot_start, const void* occ, const void* seq,
             const void* next, const void* now, void* scratch, void* out_src, void* out_ts,
             void* out_kind, void* out_valid, void* n_slot, void* new_src, void* new_occ,
             void* new_seq, void* new_next, void* ovf, cudaStream_t stream) {
  if (k < 1 || k > kMaxSortKeys || P < 1) return (int)cudaErrorInvalidValue;
  SortKeys K;
  K.k = k;
  for (int q = 0; q < k; ++q) {
    K.state[q] = state_keys[q];
    K.batch[q] = batch_keys[q];
    K.type[q] = types[q];
    K.desc[q] = desc[q];
  }
  auto kernel = k == 1 ? psort_kernel<1> : k == 2 ? psort_kernel<2> : k == 3 ? psort_kernel<3>
                                                                       : psort_kernel<0>;
  kernel<<<(P + kSlotWarps - 1) / kSlotWarps, 32 * kSlotWarps, 0, stream>>>(
      W, P, K, slot_bytes, (const int64_t*)ts, (const int32_t*)rowlist,
      (const int32_t*)slot_start, (const bool*)occ, (const int64_t*)seq, (const int64_t*)next,
      (const int64_t*)now, (char*)scratch, (int32_t*)out_src, (int64_t*)out_ts,
      (int8_t*)out_kind, (bool*)out_valid, (int32_t*)n_slot, (int32_t*)new_src, (bool*)new_occ,
      (int64_t*)new_seq, (int64_t*)new_next, (bool*)ovf);
  return (int)cudaGetLastError();
}

int sw_pfrequent(int B, int W, int P, int slot_bytes, const void* ts, const void* key,
                 const void* rowlist, const void* slot_start, const void* occ, const void* skey,
                 const void* cnt, const void* now, void* scratch, void* out_src, void* out_ts,
                 void* out_kind, void* out_valid, void* n_slot, void* new_src, void* new_occ,
                 void* new_key, void* new_cnt, void* ovf, cudaStream_t stream) {
  if (P < 1) return (int)cudaErrorInvalidValue;
  pfrequent_kernel<<<(P + kSlotWarps - 1) / kSlotWarps, 32 * kSlotWarps, 0, stream>>>(
      W, P, slot_bytes, (const int64_t*)ts, (const int64_t*)key, (const int32_t*)rowlist,
      (const int32_t*)slot_start, (const bool*)occ, (const int64_t*)skey, (const int32_t*)cnt,
      (const int64_t*)now, (char*)scratch, (int32_t*)out_src, (int64_t*)out_ts,
      (int8_t*)out_kind, (bool*)out_valid, (int32_t*)n_slot, (int32_t*)new_src, (bool*)new_occ,
      (int64_t*)new_key, (int32_t*)new_cnt, (bool*)ovf);
  return (int)cudaGetLastError();
}

int sw_lossy(int B, int C, long long width, float support_minus_error, const void* valid,
             const void* kind, const void* ts, const void* key, const void* occ,
             const void* skey, const void* cnt, const void* bucket, const void* total,
             const void* now, void* scratch, void* out_src, void* out_ts, void* out_kind,
             void* out_valid, void* new_src, void* new_occ, void* new_key, void* new_cnt,
             void* new_bucket, void* new_total, void* ovf, cudaStream_t stream) {
  int in_smem = 0;
  const size_t tile = (size_t)kTile * 17;
  const int bytes = smem_for(lossy_kernel, tile, (size_t)sw_lossy_slot_bytes(C), &in_smem);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  lossy_kernel<<<1, kThreads, bytes, stream>>>(
      B, C, width, support_minus_error, (const bool*)valid, (const int8_t*)kind,
      (const int64_t*)ts, (const int64_t*)key, (const bool*)occ, (const int64_t*)skey,
      (const int64_t*)cnt, (const int64_t*)bucket, (const int64_t*)total, (const int64_t*)now,
      (char*)scratch, in_smem, (int32_t*)out_src, (int64_t*)out_ts, (int8_t*)out_kind,
      (bool*)out_valid, (int32_t*)new_src, (bool*)new_occ, (int64_t*)new_key,
      (int64_t*)new_cnt, (int64_t*)new_bucket, (int64_t*)new_total, (bool*)ovf);
  return (int)cudaGetLastError();
}

int sw_cron(int B, int W, const void* valid, const void* kind, const void* ts,
            const void* cur_ts, const void* cur_n, const void* prev_ts, const void* prev_n,
            const void* now, void* scratch, void* out_src, void* out_ts, void* out_kind,
            void* out_valid, void* new_cur_src, void* new_prev_src, void* new_cur_n,
            void* new_prev_n, void* ovf, cudaStream_t stream) {
  int in_smem = 0;
  const size_t tile = kTile;
  const int bytes = smem_for(cron_kernel, tile, (size_t)sw_cron_slot_bytes(W), &in_smem);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  cron_kernel<<<1, kThreads, bytes, stream>>>(
      B, W, (const bool*)valid, (const int8_t*)kind, (const int64_t*)ts, (const int64_t*)cur_ts,
      (const int32_t*)cur_n, (const int64_t*)prev_ts, (const int32_t*)prev_n,
      (const int64_t*)now, (int32_t*)scratch, in_smem, (int32_t*)out_src, (int64_t*)out_ts,
      (int8_t*)out_kind, (bool*)out_valid, (int32_t*)new_cur_src, (int32_t*)new_prev_src,
      (int32_t*)new_cur_n, (int32_t*)new_prev_n, (bool*)ovf);
  return (int)cudaGetLastError();
}

int sw_plossy(int B, int C, int P, long long width, float support_minus_error,
              const void* ts, const void* key, const void* rowlist, const void* slot_start,
              const void* occ, const void* skey, const void* cnt, const void* bucket,
              const void* total, const void* now, void* scratch, void* out_src, void* out_ts,
              void* out_kind, void* out_valid, void* n_slot, void* new_src, void* new_occ,
              void* new_key, void* new_cnt, void* new_bucket, void* new_total, void* ovf,
              cudaStream_t stream) {
  if (P < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const long long slot_bytes = (sw_lossy_slot_bytes(C) + 15) / 16 * 16;
  const int in_smem = sw_slot_bytes(4, C, 0) == 0;
  const int smem = in_smem ? (int)(kSlotWarps * slot_bytes) : 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(plossy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
          cudaSuccess) {
    return (int)cudaErrorInvalidValue;
  }
  if (!in_smem && scratch == nullptr) return (int)cudaErrorInvalidValue;
  plossy_kernel<<<(P + kSlotWarps - 1) / kSlotWarps, 32 * kSlotWarps, smem, stream>>>(
      B, C, P, width, support_minus_error, (int)slot_bytes, in_smem, (const int64_t*)ts,
      (const int64_t*)key, (const int32_t*)rowlist, (const int32_t*)slot_start,
      (const bool*)occ, (const int64_t*)skey, (const int64_t*)cnt, (const int64_t*)bucket,
      (const int64_t*)total, (const int64_t*)now, (char*)scratch, (int32_t*)out_src,
      (int64_t*)out_ts, (int8_t*)out_kind, (bool*)out_valid, (int32_t*)n_slot,
      (int32_t*)new_src, (bool*)new_occ, (int64_t*)new_key, (int64_t*)new_cnt,
      (int64_t*)new_bucket, (int64_t*)new_total, (bool*)ovf);
  return (int)cudaGetLastError();
}

int sw_pcron(int W, int P, const void* ts, const void* rowlist, const void* slot_start,
             const void* timers, const void* info, const void* cur_ts, const void* cur_n,
             const void* prev_ts, const void* prev_n, const void* now, const void* off,
             const void* cap, void* scratch, void* out_src, void* out_ts, void* out_kind,
             void* out_valid, void* n_slot, void* new_cur_src, void* new_prev_src,
             void* new_cur_n, void* new_prev_n, void* ovf, cudaStream_t stream) {
  if (P < 1 || W < 1) return (int)cudaErrorInvalidValue;
  pcron_kernel<<<(P + kSlotWarps - 1) / kSlotWarps, 32 * kSlotWarps, 0, stream>>>(
      W, P, (const int64_t*)ts, (const int32_t*)rowlist, (const int32_t*)slot_start,
      (const int32_t*)timers, (const int32_t*)info, (const int64_t*)cur_ts,
      (const int32_t*)cur_n, (const int64_t*)prev_ts, (const int32_t*)prev_n,
      (const int64_t*)now, (const int64_t*)off, (const int32_t*)cap, (int32_t*)scratch,
      (int32_t*)out_src, (int64_t*)out_ts, (int8_t*)out_kind, (bool*)out_valid,
      (int32_t*)n_slot, (int32_t*)new_cur_src, (int32_t*)new_prev_src, (int32_t*)new_cur_n,
      (int32_t*)new_prev_n, (bool*)ovf);
  return (int)cudaGetLastError();
}

// Fill `n` lanes of `rows` rows from up to three sources laid end to end
// (n0 and n1 rows long; the third unbounded) through `idx` (-1: zero).
int sw_gather(int n, const void* const* s0, const void* const* s1, const void* const* s2,
              void* const* out, const int* size, const void* idx, int rows, int n0, int n1,
              cudaStream_t stream) {
  if (rows <= 0) return 0;
  for (int base = 0; base < n; base += kMaxLanes) {
    Lanes L;
    const int m = n - base < kMaxLanes ? n - base : kMaxLanes;
    for (int l = 0; l < m; ++l) {
      L.s0[l] = s0[base + l];
      L.s1[l] = s1[base + l];
      L.s2[l] = s2[base + l];
      L.out[l] = out[base + l];
      L.size[l] = size[base + l];
    }
    int blocks = (rows + 255) / 256;
    blocks = blocks > 1024 ? 1024 : blocks;
    gather_kernel<<<dim3(blocks, m), 256, 0, stream>>>(L, (const int32_t*)idx, rows, n0, n1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
