// K44 / K45: the incremental aggregation's duration-chain step and the
// in-flight merge of a find (siddhi_tpu/core/aggregation.py `_step_impl`,
// `_merge_into`, `_find_impl`).
//
// The state is one bucket store a duration (D <= 6, finest first): G group
// keys, used flags and one lane a base (sum/count add, min/max fold as
// XLA's scatter-min/max, last sets), and the open bucket's start (-1 before
// the first row). The JAX package scans the batch's rows; here one block
// walks them in order, its threads over the G slots of a store:
//   - a tile of rows is staged in shared memory by the block, a thread a
//     row: its flags, keys, base contributions and aligned bucket per
//     duration (floor division; months and years by the civil calendar);
//     the walk's decisions depend on these and on the control state (each
//     store's bucket, used count and spill count, the flag), which every
//     thread keeps alike in its registers: no read-back. The block also
//     marks the rows that may change the control state (a close, a
//     bucket's first start) given the state now, and marks again after
//     each such row; every other row only absorbs into the finest store;
//   - the finest duration closes first and then absorbs the row: warp 0
//     does it alone (lane 0 finds the row's key through a key -> slot index
//     of the finest store in shared memory, or takes the next slot; lane b
//     folds base b), so the rest of the block only joins on marked rows;
//     the finest store itself sits in shared memory while it fits;
//   - a close copies the store into the step's spill buffer (the first
//     kSpills closes of a duration; later ones only set the flag), into a
//     roll buffer (the closed store the next coarser duration absorbs), and
//     resets it; a coarser duration absorbs its child's closed store through
//     `block_merge`, then closes on the row's own time;
//   - `block_merge` is `_merge_into`: each used source slot looks its key
//     up in an index of the destination's used slots (built by the block),
//     the misses are ranked by a block scan from the used count, and a rank
//     at G or past is dropped with the flag set. K45 folds the finest ..
//     `per` stores through it. Past ~4,096 groups the indexes do not fit in
//     shared memory, and a lookup scans the store instead.
// The used slots of a store are a prefix (they fill in order and a close
// empties the store), so the used count is where the next key goes.
// Floats are added one at a time in row order (__fadd_rn, no contraction;
// a NaN as the host's add leaves it), the scan's own order, so the kernel
// equals its plain twin bit for bit.
// What bounds it: the rows are walked one after another (each depends on the
// store the last left) by one warp: a shared-memory probe, a shuffle and a
// read-modify-write a base a CURRENT row (the lanes diverge by the bases'
// types); closes are rare (about one a second of event time for the
// finest duration).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxBases = 32;
constexpr int kMaxDur = 6;
constexpr int kSpills = 4;  // SPILLS_PER_BATCH
constexpr int kTile = 256;
constexpr int kMaxThreads = 256;
constexpr long long kDayMs = 86400000LL;
constexpr int kSum = 0, kMin = 1, kMax = 2;  // 3: last
constexpr int kF32 = 0, kI32 = 1, kI64 = 2, kB8 = 3;  // kB8: bool (one byte)

struct Bases {
  int n;
  int op[kMaxBases];
  int type[kMaxBases];
  long long init[kMaxBases];  // the empty store's value, as bits
};

// One store's lanes: slot j of base b at vals[b] + j * size(b).
struct Store {
  long long* keys;
  bool* used;
  char* vals[kMaxBases];
};

__host__ __device__ __forceinline__ int type_size(int t) {
  return t == kI64 ? 8 : t == kB8 ? 1 : 4;
}

// wrapping int64 arithmetic (the JAX package's int64 wraps)
__device__ __forceinline__ long long wmul(long long a, long long b) {
  return (long long)((unsigned long long)a * (unsigned long long)b);
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {  // b > 0
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ long long days_from_civil(long long y, long long m, long long d) {
  y -= m <= 2;
  const long long era = floor_div(y, 400);
  const long long yoe = y - era * 400;
  const long long mp = m > 2 ? m - 3 : m + 9;
  const long long doy = (153 * mp + 2) / 5 + d - 1;
  const long long doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

// The start of the bucket of `dur` (millis; -2 months, -1 years) holding ts
// (siddhi_tpu/core/aggregation.py `align_bucket`, Hinnant's algorithms).
__device__ __forceinline__ long long align_bucket(long long ts, int dur) {
  if (dur > 0) return wmul(floor_div(ts, dur), dur);
  const long long z = floor_div(ts, kDayMs) + 719468;
  const long long era = floor_div(z, 146097);
  const long long doe = z - era * 146097;
  const long long yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const long long doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const long long mp = (5 * doy + 2) / 153;
  const long long m = mp + (mp < 10 ? 3 : -9);
  const long long y = yoe + era * 400 + (m <= 2);
  return wmul(days_from_civil(y, dur == -2 ? m : 1, 1), kDayMs);
}

// XLA's scatter-min / -max on float32: NaN wins; -0.0 is the lesser zero.
__device__ __forceinline__ float fmin_xla(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a < b) return a;
  if (b < a) return b;
  return signbit(a) ? a : b;
}

__device__ __forceinline__ float fmax_xla(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  if (a > b) return a;
  if (b > a) return b;
  return signbit(a) ? b : a;
}

// a + b as the host's float32 add leaves a NaN (the reference scan and the
// plain twin run there): a NaN operand comes through (the first, quieted),
// and inf - inf gives the default NaN 0xffc00000. The card's own add would
// give its canonical 0x7fffffff.
__device__ __forceinline__ float fadd_host_nan(float a, float b) {
  if (isnan(a)) return __int_as_float(__float_as_int(a) | 0x00400000);
  if (isnan(b)) return __int_as_float(__float_as_int(b) | 0x00400000);
  const float s = xla_add(a, b);
  return isnan(s) ? __int_as_float((int)0xffc00000u) : s;
}

// dst[i] = fold(dst[i], src[j]) for one base
__device__ __forceinline__ void fold(int op, int type, char* dst, long long i, const char* src,
                                     long long j) {
  switch (type) {
    case kF32: {
      float* d = (float*)dst + i;
      const float s = ((const float*)src)[j];
      // XLA's scatter-add/min/max read subnormals as zeros (xla_add flushes
      // its sum too); `last` copies the bits
      *d = op == kSum ? fadd_host_nan(*d, s)
           : op == kMin ? fmin_xla(flush_subnormal(*d), flush_subnormal(s))
           : op == kMax ? fmax_xla(flush_subnormal(*d), flush_subnormal(s)) : s;
      break;
    }
    case kI32: {
      int* d = (int*)dst + i;
      const int s = ((const int*)src)[j];
      *d = op == kSum ? (int)((unsigned)*d + (unsigned)s) : op == kMin ? min(*d, s)
           : op == kMax ? max(*d, s) : s;
      break;
    }
    case kI64: {
      long long* d = (long long*)dst + i;
      const long long s = ((const long long*)src)[j];
      *d = op == kSum ? (long long)((unsigned long long)*d + (unsigned long long)s)
           : op == kMin ? min(*d, s) : op == kMax ? max(*d, s) : s;
      break;
    }
    default:
      ((unsigned char*)dst)[i] = ((const unsigned char*)src)[j];
  }
}

__device__ __forceinline__ void copy_val(int type, char* dst, long long i, const char* src,
                                         long long j) {
  switch (type_size(type)) {
    case 8: ((long long*)dst)[i] = ((const long long*)src)[j]; break;
    case 4: ((int*)dst)[i] = ((const int*)src)[j]; break;
    default: ((unsigned char*)dst)[i] = ((const unsigned char*)src)[j];
  }
}

__device__ __forceinline__ void set_bits(int type, char* dst, long long i, long long bits) {
  switch (type_size(type)) {
    case 8: ((long long*)dst)[i] = bits; break;
    case 4: ((int*)dst)[i] = (int)bits; break;
    default: ((unsigned char*)dst)[i] = (unsigned char)bits;
  }
}

__device__ __forceinline__ Store store_at(long long* keys, bool* used, char* const* vals,
                                          const Bases& B, long long off) {
  Store s;
  s.keys = keys + off;
  s.used = used + off;
  for (int b = 0; b < B.n; ++b) s.vals[b] = vals[b] + off * type_size(B.type[b]);
  return s;
}

// A key -> slot index of one store's used slots in shared memory: open
// addressing over H slots (a power of two, at least 2G; -1 empty). H == 0:
// no index (G too large for shared memory), and a lookup scans the store.
// The keys of a store's used slots are distinct (a key joins a store only
// when no used slot holds it), so the one hit is the JAX merge's first.
struct KeyIndex {
  long long* key;
  int* slot;
  int H;
};

__device__ __forceinline__ unsigned kx_hash(long long k) {
  unsigned long long z = (unsigned long long)k;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return (unsigned)(z ^ (z >> 31));
}

__device__ __forceinline__ int kx_find(const KeyIndex& x, const Store& s, int G, long long k) {
  if (x.H == 0) {
    for (int j = 0; j < G; ++j) {
      if (s.used[j] && s.keys[j] == k) return j;
    }
    return -1;
  }
  for (unsigned i = kx_hash(k) & (x.H - 1);; i = (i + 1) & (x.H - 1)) {
    const int sl = x.slot[i];
    if (sl < 0) return -1;
    if (x.key[i] == k) return sl;
  }
}

// one insert (threads may insert at once: a slot is claimed by atomicCAS)
__device__ __forceinline__ void kx_insert(const KeyIndex& x, long long k, int slot) {
  for (unsigned i = kx_hash(k) & (x.H - 1);; i = (i + 1) & (x.H - 1)) {
    if (atomicCAS(&x.slot[i], -1, slot) == -1) {
      x.key[i] = k;
      return;
    }
  }
}

// the index of store s's used slots, built by the block (barriers inside)
__device__ __forceinline__ void kx_build(const KeyIndex& x, const Store& s, int G) {
  if (x.H == 0) return;
  for (int i = threadIdx.x; i < x.H; i += blockDim.x) x.slot[i] = -1;
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    if (s.used[g]) kx_insert(x, s.keys[g], g);
  }
  __syncthreads();
}

// `_merge_into` of src's used slots (where `has`) into dst, whose used count
// is n_used: a hit folds into the first used slot holding the key (found
// through the index x of dst's used slots, built here), a miss takes slot
// n_used + its rank among the misses, dropped (flag set) at G or past.
// Every thread calls it; it ends on a barrier. Returns the used count.
__device__ __noinline__ int block_merge(const Bases& B, const Store& dst, const Store& src,
                                        bool has, int G, int n_used, bool* ovf, int* ws,
                                        const KeyIndex& x) {
  kx_build(x, dst, G);
  int carry = 0;
  bool mo = false;
  for (int c0 = 0; c0 < G; c0 += blockDim.x) {
    const int i = c0 + threadIdx.x;
    const bool su = has && i < G && src.used[i];
    const int hit = su ? kx_find(x, dst, G, src.keys[i]) : -1;
    const bool miss = su && hit < 0;
    int tot;
    const int rank = block_excl_sum(miss ? 1 : 0, ws, &tot) + carry;
    int slot = hit;
    if (miss) {
      slot = n_used + rank < G ? n_used + rank : -1;
      mo = mo || slot < 0;
    }
    if (slot >= 0) {
      for (int b = 0; b < B.n; ++b) fold(B.op[b], B.type[b], dst.vals[b], slot, src.vals[b], i);
    }
    // the new keys are written after every thread of the chunk has searched
    __syncthreads();
    if (miss && slot >= 0) {
      dst.keys[slot] = src.keys[i];
      dst.used[slot] = true;
    }
    carry += tot;
  }
  if (__syncthreads_or(mo)) *ovf = true;
  return n_used + carry < G ? n_used + carry : G;
}

// The bytes of one store held in shared memory: keys, each base's lane
// (8-byte aligned), the used flags.
__host__ __device__ __forceinline__ long long store_bytes(const Bases& B, int G) {
  long long n = 8LL * G;
  for (int b = 0; b < B.n; ++b) {
    n += ((long long)type_size(B.type[b]) * G + 7) / 8 * 8;
  }
  return n + G;
}

__device__ __forceinline__ Store store_in(char* p, const Bases& B, int G) {
  Store s;
  s.keys = (long long*)p;
  p += 8LL * G;
  for (int b = 0; b < B.n; ++b) {
    s.vals[b] = p;
    p += ((long long)type_size(B.type[b]) * G + 7) / 8 * 8;
  }
  s.used = (bool*)p;
  return s;
}

__device__ __forceinline__ void copy_store(const Bases& B, const Store& dst, const Store& src,
                                           int G) {
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    dst.keys[g] = src.keys[g];
    dst.used[g] = src.used[g];
    for (int b = 0; b < B.n; ++b) copy_val(B.type[b], dst.vals[b], g, src.vals[b], g);
  }
}

// do_close's copies for duration d: the store spilled (the first kSpills
// closes a step, sn of them so far), handed to the roll buffer and reset;
// the finest store's index (d == 0) emptied. Every thread calls it; barriers
// on entry (warp 0's row updates are in) and on exit. Out of line, as
// block_merge: both run on marked rows alone.
__device__ __noinline__ void close_copy(const Bases& B, char* const* sp_vals, const Store& s,
                                        const Store& roll, int d, int G, int sn, long long bucket,
                                        int64_t* sp_ts, int64_t* sp_keys, bool* sp_used,
                                        const KeyIndex& h0) {
  __syncthreads();
  const int tid = threadIdx.x;
  const bool spill = sn < kSpills;
  const long long so = ((long long)d * kSpills + (spill ? sn : 0)) * G;
  for (int g = tid; g < G; g += blockDim.x) {
    roll.keys[g] = s.keys[g];
    roll.used[g] = s.used[g];
    if (spill) {
      sp_keys[so + g] = s.keys[g];
      sp_used[so + g] = s.used[g];
    }
    for (int b = 0; b < B.n; ++b) {
      copy_val(B.type[b], roll.vals[b], g, s.vals[b], g);
      if (spill) copy_val(B.type[b], sp_vals[b], so + g, s.vals[b], g);
      set_bits(B.type[b], s.vals[b], g, B.init[b]);
    }
    s.keys[g] = 0;
    s.used[g] = false;
  }
  if (d == 0) {
    for (int i = tid; i < h0.H; i += blockDim.x) h0.slot[i] = -1;
  }
  if (spill && tid == 0) sp_ts[d * kSpills + sn] = bucket;
  __syncthreads();
}

struct StepArgs {
  Bases B;
  int dur[kMaxDur];
  const void* contrib[kMaxBases];
  const char* in_vals[kMaxBases];
  char* vals[kMaxBases];
  char* sp_vals[kMaxBases];
};

// The step. Warp 0 absorbs the rows into the finest store (lane 0 finds or
// takes the row's slot through the finest store's index h0, lane b folds
// base b from the tile's contributions staged in shared memory); the whole
// block joins on each close (a barrier first, then the copies) and on each
// rollup merge. Dynamic shared memory: the two key indexes (H slots each),
// the tile's contributions, and, when st0_smem, the finest store itself
// (written back at the end).
__global__ void step_kernel(StepArgs A, int nrows, int G, int D, int H, int st0_smem,
                            const int64_t* ts,
                            const bool* live, const bool* timer, const int64_t* key,
                            const int64_t* in_keys, const bool* in_used,
                            const int64_t* in_bucket, int64_t* keys, bool* used,
                            int64_t* bucket_out, int64_t* sp_ts, int64_t* sp_keys, bool* sp_used,
                            int32_t* spill_n, char* scratch, bool* ovf_out) {
  const Bases& B = A.B;
  extern __shared__ __align__(16) char smem[];
  __shared__ long long tts[kTile], tkey[kTile];
  __shared__ long long tnb[kMaxDur][kTile];  // each row's aligned bucket a duration
  __shared__ unsigned char tflag[kTile], tneed[kTile];
  __shared__ int ws[32];
  const KeyIndex h0{(long long*)smem, (int*)(smem + (size_t)H * 8), H};
  const KeyIndex hm{(long long*)(smem + (size_t)H * 12), (int*)(smem + (size_t)H * 20), H};
  char* tcon = smem + (size_t)H * 24;  // base b's tile at tcon + b * kTile * 8
  const int tid = threadIdx.x, lane = tid & 31;
  const long long DG = (long long)D * G;
  // the stores into the output lanes, the spills zeroed
  for (long long e = tid; e < DG; e += blockDim.x) {
    keys[e] = in_keys[e];
    used[e] = in_used[e];
    for (int b = 0; b < B.n; ++b) copy_val(B.type[b], A.vals[b], e, A.in_vals[b], e);
  }
  for (long long e = tid; e < DG * kSpills; e += blockDim.x) {
    sp_keys[e] = 0;
    sp_used[e] = false;
    for (int b = 0; b < B.n; ++b) set_bits(B.type[b], A.sp_vals[b], e, 0);
  }
  for (int e = tid; e < D * kSpills; e += blockDim.x) sp_ts[e] = 0;
  // the roll buffer: the store a close hands to the next coarser duration
  char* p = (char*)(((uintptr_t)scratch + 15) & ~(uintptr_t)15);
  Store roll;
  roll.keys = (long long*)p;
  roll.used = (bool*)(roll.keys + G);
  char* rv = (char*)roll.used + ((G + 15) & ~15);
  for (int b = 0; b < B.n; ++b) roll.vals[b] = rv + (size_t)b * G * 8;
  __syncthreads();

  long long bucket[kMaxDur];
  int n_used[kMaxDur], sn[kMaxDur];
  const Store st0_global = store_at((long long*)keys, used, A.vals, B, 0);
  const Store st0 = st0_smem ? store_in(tcon + (size_t)B.n * kTile * 8, B, G) : st0_global;
  if (st0_smem) {
    copy_store(B, st0, st0_global, G);
    __syncthreads();
  }
  // the coarser stores' lanes are found when a close or a merge needs them
  auto store_of = [&](int d) {
    return d == 0 ? st0 : store_at((long long*)keys, used, A.vals, B, (long long)d * G);
  };
  // (the duration loops are unrolled: the control state stays in registers)
#pragma unroll
  for (int d = 0; d < kMaxDur; ++d) {
    if (d < D) {
      bucket[d] = in_bucket[d];
      sn[d] = 0;
      const bool* u = d == 0 ? st0.used : used + (long long)d * G;
      int n = 0;
      for (int c0 = 0; c0 < G; c0 += blockDim.x) {
        const int g = c0 + tid;
        n += __syncthreads_count(g < G && u[g]);
      }
      n_used[d] = n;
    }
  }
  // lane b of warp 0 folds base b
  const bool my_base = lane < B.n;
  const int my_op = my_base ? B.op[lane] : 0, my_type = my_base ? B.type[lane] : 0;
  char* const my_dst = my_base ? st0.vals[lane] : nullptr;
  const char* const my_con = tcon + (size_t)lane * kTile * 8;
  kx_build(h0, st0, G);
  bool ovf = false, merge_ovf = false;

  // tneed[t]: row t of the tile may change the control state (a close or a
  // bucket's start at some duration) given the state now; any other row
  // only absorbs into the finest store (if CURRENT). Marked by the block
  // for the rows from `from` on, again after each row that needed it.
  auto mark = [&](int from, int rows) {
    for (int t = from + tid; t < rows; t += blockDim.x) {
      const bool adv = tflag[t] != 0;
      bool need = false;
#pragma unroll
      for (int d = 0; d < kMaxDur; ++d) {
        if (d < D) need = need || bucket[d] < 0 || (adv && tnb[d][t] > bucket[d]);
      }
      tneed[t] = need;
    }
    __syncthreads();
  };

  for (int base = 0; base < nrows; base += kTile) {
    const int rows = nrows - base < kTile ? nrows - base : kTile;
    __syncthreads();
    for (int t = tid; t < rows; t += blockDim.x) {
      const int r = base + t;
      tts[t] = ts[r];
      tkey[t] = key[r];
      tflag[t] = (live[r] ? 1 : 0) | (timer[r] ? 2 : 0);
      for (int d = 0; d < D; ++d) tnb[d][t] = align_bucket(ts[r], A.dur[d]);
      for (int b = 0; b < B.n; ++b) {
        copy_val(B.type[b], tcon + (size_t)b * kTile * 8, t, (const char*)A.contrib[b], r);
      }
    }
    __syncthreads();
    mark(0, rows);
    for (int t = 0; t < rows; ++t) {
      const unsigned char fl = tflag[t];
      const bool need = tneed[t];
      const long long rt = tts[t];
      const bool adv = fl != 0;
      // the finest duration: the row belongs to the new bucket, so close,
      // then absorb
      const long long nb0 = tnb[0][t];
      const bool crossed = need && adv && bucket[0] >= 0 && nb0 > bucket[0];
      const long long closed0 = bucket[0];
      if (crossed) {
        close_copy(B, A.sp_vals, st0, roll, 0, G, sn[0], bucket[0], sp_ts, sp_keys, sp_used,
                   h0);
        ovf = ovf || sn[0] >= kSpills;
        ++sn[0];
        bucket[0] = nb0;
        n_used[0] = 0;
      }
      if (bucket[0] < 0) bucket[0] = nb0;
      if ((fl & 1) && tid < 32) {
        // warp 0: the row's slot (lane 0), then a base a lane
        int slot = -1;
        if (lane == 0) {
          const long long k = tkey[t];
          slot = kx_find(h0, st0, G, k);
          if (slot < 0) {
            if (n_used[0] < G) {
              slot = n_used[0]++;
              st0.keys[slot] = k;
              st0.used[slot] = true;
              if (H) kx_insert(h0, k, slot);
            } else {
              ovf = true;
            }
          }
        }
        slot = __shfl_sync(kFull, slot, 0);
        if (slot >= 0 && my_base) fold(my_op, my_type, my_dst, slot, my_con, t);
        __syncwarp();
      }
      if (!need) continue;
      // a coarser duration: a child rollup belongs to the open bucket, so
      // absorb, then close on the row's own time
      bool child_closed = crossed;
      long long roll_ts = crossed ? closed0 : rt;
#pragma unroll
      for (int d = 1; d < kMaxDur; ++d) {
        if (d < D) {
          const long long nb = tnb[d][t];
          if (child_closed) {
            n_used[d] = block_merge(B, store_of(d), roll, true, G, n_used[d], &merge_ovf, ws,
                                    hm);
          }
          if (bucket[d] < 0) bucket[d] = roll_ts == rt ? nb : align_bucket(roll_ts, A.dur[d]);
          const bool closing = adv && bucket[d] >= 0 && nb > bucket[d];
          const long long closed = bucket[d];
          if (closing) {
            close_copy(B, A.sp_vals, store_of(d), roll, d, G, sn[d], bucket[d], sp_ts, sp_keys,
                       sp_used, h0);
            ovf = ovf || sn[d] >= kSpills;
            ++sn[d];
            bucket[d] = nb;
            n_used[d] = 0;
          }
          child_closed = closing;
          roll_ts = closing ? closed : rt;
        }
      }
      mark(t + 1, rows);
    }
  }
  __syncthreads();
  if (st0_smem) copy_store(B, st0_global, st0, G);
  ovf = ovf || merge_ovf;
  if (tid == 0) {  // thread 0 holds every flag (its lane took the finest rows)
#pragma unroll
    for (int d = 0; d < kMaxDur; ++d) {
      if (d < D) {
        bucket_out[d] = bucket[d];
        spill_n[d] = sn[d];
      }
    }
    *ovf_out = ovf;
  }
}

struct FindArgs {
  Bases B;
  const char* vals[kMaxBases];
  char* out_vals[kMaxBases];
};

__global__ void find_kernel(FindArgs A, int G, int n_stores, int per, int H, const int64_t* keys,
                            const bool* used, const int64_t* bucket, int64_t* out_keys,
                            bool* out_used, int64_t* out_bucket, bool* ovf_out) {
  const Bases& B = A.B;
  extern __shared__ __align__(16) char smem[];
  __shared__ int ws[32];
  const KeyIndex hm{(long long*)smem, (int*)(smem + (size_t)H * 8), H};
  Store temp;
  temp.keys = (long long*)out_keys;
  temp.used = out_used;
  for (int b = 0; b < B.n; ++b) temp.vals[b] = A.out_vals[b];
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    temp.keys[g] = 0;
    temp.used[g] = false;
    for (int b = 0; b < B.n; ++b) set_bits(B.type[b], temp.vals[b], g, B.init[b]);
  }
  __syncthreads();
  long long tb = -1;
  int n_used = 0;
  bool ovf = false;
  for (int d = 0; d < n_stores; ++d) {
    const bool has = bucket[d] >= 0;
    const long long aligned = has ? align_bucket(bucket[d] > 0 ? bucket[d] : 0, per) : -1;
    Store src = store_at((long long*)keys, (bool*)used, (char* const*)A.vals, B,
                         (long long)d * G);
    n_used = block_merge(B, temp, src, has, G, n_used, &ovf, ws, hm);
    if (tb < 0) tb = aligned;
  }
  if (threadIdx.x == 0) {
    *out_bucket = tb;
    *ovf_out = ovf;
  }
}

Bases make_bases(int nb, const int* op, const int* type, const long long* init) {
  Bases B;
  B.n = nb;
  for (int b = 0; b < nb; ++b) {
    B.op[b] = op[b];
    B.type[b] = type[b];
    B.init[b] = init[b];
  }
  return B;
}

int threads_for(int G) {
  int t = (G + 31) / 32 * 32;
  return t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t;
}

// The slots of a key index for G groups (a power of two, at least 2G) when
// `tables` of them (12 bytes a slot) fit in the dynamic shared memory left
// beside `static_bytes`, else 0 (lookups scan the store). *bytes: the
// dynamic shared memory to ask for; -1 if the kernel refuses it.
template <typename F>
int index_slots(F kernel, int G, int tables, int static_bytes, int* bytes) {
  int dev = 0, cap = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  long long h = 32;
  while (h < 2LL * G) h <<= 1;
  if ((long long)tables * h * 12 > cap - static_bytes - 1024) h = 0;
  *bytes = (int)(tables * h * 12);
  // the static arrays count against the same 48 KB default: opt in always
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *bytes) !=
      cudaSuccess) {
    *bytes = -1;
  }
  return (int)h;
}

}  // namespace

extern "C" {

// K44: one step of the duration chain over `rows` rows (see the header).
int agg_step(int rows, int G, int D, int nb, const int* op, const int* type,
             const long long* init, const int* dur, const void* ts, const void* live,
             const void* timer, const void* key, const void* const* contrib,
             const void* in_keys, const void* in_used, const void* const* in_vals,
             const void* in_bucket, void* keys, void* used, void* const* vals, void* bucket,
             void* sp_ts, void* sp_keys, void* sp_used, void* const* sp_vals, void* spill_n,
             void* scratch, void* ovf, cudaStream_t stream) {
  if (nb < 1 || nb > kMaxBases || D < 1 || D > kMaxDur || G < 1) {
    return (int)cudaErrorInvalidValue;
  }
  StepArgs A;
  A.B = make_bases(nb, op, type, init);
  for (int d = 0; d < D; ++d) A.dur[d] = dur[d];
  for (int b = 0; b < nb; ++b) {
    A.contrib[b] = contrib[b];
    A.in_vals[b] = (const char*)in_vals[b];
    A.vals[b] = (char*)vals[b];
    A.sp_vals[b] = (char*)sp_vals[b];
  }
  // the tile's contributions, the two key indexes and the finest store in
  // shared memory when they fit, else the indexes and the store in global
  // memory (lookups then scan the store)
  const long long tile = (long long)nb * kTile * 8, st0 = store_bytes(A.B, G);
  int bytes = 0, st0_smem = 1;
  int H = index_slots(step_kernel, G, 2, 16 * 1024 + (int)(tile + st0), &bytes);
  if (H == 0) {
    st0_smem = 0;
    H = index_slots(step_kernel, G, 2, 16 * 1024 + (int)tile, &bytes);
  }
  bytes += (int)tile + (st0_smem ? (int)st0 : 0);
  if (bytes < (int)tile ||
      cudaFuncSetAttribute(step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) !=
          cudaSuccess) {
    return (int)cudaErrorInvalidValue;
  }
  step_kernel<<<1, threads_for(G), bytes, stream>>>(
      A, rows, G, D, H, st0_smem, (const int64_t*)ts, (const bool*)live, (const bool*)timer,
      (const int64_t*)key, (const int64_t*)in_keys, (const bool*)in_used,
      (const int64_t*)in_bucket, (int64_t*)keys, (bool*)used, (int64_t*)bucket,
      (int64_t*)sp_ts, (int64_t*)sp_keys, (bool*)sp_used, (int32_t*)spill_n, (char*)scratch,
      (bool*)ovf);
  return (int)cudaGetLastError();
}

// K45: the stores 0 .. n_stores - 1 merged into one aligned to `per`.
int agg_find(int G, int n_stores, int per, int nb, const int* op, const int* type,
             const long long* init, const void* keys, const void* used,
             const void* const* vals, const void* bucket, void* out_keys, void* out_used,
             void* const* out_vals, void* out_bucket, void* ovf, cudaStream_t stream) {
  if (nb < 1 || nb > kMaxBases || n_stores < 1 || n_stores > kMaxDur || G < 1) {
    return (int)cudaErrorInvalidValue;
  }
  FindArgs A;
  A.B = make_bases(nb, op, type, init);
  for (int b = 0; b < nb; ++b) {
    A.vals[b] = (const char*)vals[b];
    A.out_vals[b] = (char*)out_vals[b];
  }
  int bytes = 0;
  const int H = index_slots(find_kernel, G, 1, 1024, &bytes);
  if (bytes < 0) return (int)cudaErrorInvalidValue;
  find_kernel<<<1, threads_for(G), bytes, stream>>>(
      A, G, n_stores, per, H, (const int64_t*)keys, (const bool*)used, (const int64_t*)bucket,
      (int64_t*)out_keys, (bool*)out_used, (int64_t*)out_bucket, (bool*)ovf);
  return (int)cudaGetLastError();
}

}  // extern "C"
