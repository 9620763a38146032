// The per-event scan of the pattern engine for Hopper (sm_90a): one launch
// applies every row of a step (a data batch of one stream, or a one-row
// TIMER batch) to the token table, in order.
//
// Replaces siddhi_tpu/core/pattern.py PatternProgram.apply_event :566-1059
// under the lax.scan of siddhi_tpu/core/pattern_runtime.py
// PatternQueryRuntime._make_step :228-279, with the token-table helpers it
// calls (_merge :1063, _consume :1091, _arrival_effects :1099,
// _clear_slot_caps :1117, _rearm_block :1149, _arm_virgins :1215,
// _advance_rows :1251, _alloc_lanes :1259, _fork :1271, _eligible :518,
// _capture :546, _token_env :486 with _synth_capture_cols :448, and
// _write_emits :1933). Within one row the JAX order exactly: the within
// kills; the re-arm of a sequence's start state; the deadline blocks in
// slot order (absent, both-absent logical, logical with one absent side),
// fired by eff_now = max(ts, timer_seen); the atoms in descending slot
// order, each with its eligibility, its condition programs, then the
// absent marker / kill / re-arm or the capture with the logical
// completion, count absorb, emission, fork, move, block re-arm and virgin
// arming; sequence strictness; the fwd contest.
//
// Design: one thread block per step loops over the rows. The NFA is a
// descriptor table built once per program on the host
// (PatternProgram.scan_desc: per slot its kind, count bounds, `every`,
// within, the every-block it ends and its deadline kind; per ref its slot,
// absence, waiting time, capture capacity and condition programs), which the
// kernel interprets, so one binary serves every pattern. The control lanes
// (active, slot, start_ts, entry_ts, fwd, each ref's count) and the per-lane
// scratch live in shared memory when they fit (dynamic, above 48 KB up to
// the card's 227 KB), in global scratch otherwise; capture lanes stay in
// global memory. A row's work is sized to its live lanes, not to T:
//   - every pass runs over a list of the live lanes in ascending order (the
//     active or fwd-marked ones, a T-bit word mask beside it), compacted
//     before a row that follows kills or consumptions, and joined by the
//     lanes a fork, re-arm or virgin allocates, whose row scratch starts as
//     an idle lane's would;
//   - the rows are walked by a group of the block's first W warps, W the
//     live count in warps: one warp syncs as a warp (__syncwarp, votes),
//     more on named barrier 1 over just their threads, while the other
//     warps wait at barrier 0 until the group asks for another width;
//   - a lane allocation (_alloc_lanes: the rank-th free lane in ascending
//     order, JAX's stable argsort) ranks the allocating lanes over the list
//     and finds each free lane by a popcount prefix over the free words;
//   - a row whose refs' row masks are all clear, before the live lanes'
//     earliest deadline, of a pattern that is no sequence and has no fwd
//     lane, changes nothing but its within kills: it is skipped, and the
//     kills come due at the next row that runs, at the largest ts skipped
//     (a kill is sticky and monotone in ts). TIMER rows always run.
// A copy into allocated lanes stages its sources first, as JAX's scatters
// read the table before writing it; an emission appends in lane order at
// out_n. The row filters that read only the event arrive as an [R, B] mask
// (each capture-free top-level conjunct of a condition among them); the
// token-dependent ones are postfix condition programs (core/pattern.py
// CondProgram, csrc/prog.cuh), interpreted per eligible lane, with
// capture-free subtrees as row registers. Float arithmetic uses the
// round-to-nearest intrinsics (no contraction), so the results equal the
// plain PyTorch version's bit for bit. ScanArgs.opt turns each of the three
// steps (the list, the group width, the skip) off, for timing them alone.
// K37, the keyed form inside a partition (`pps_scan`; replaces
// siddhi_tpu/core/partition.py :326 and :378, the vmap of this step over P
// partition lanes): one block a used slot runs the same code on its [T]
// lanes of a [P*T] table, over its member rows merged with the TIMER rows
// in row order, with its own timer_seen, into its own stretch of the
// emission lanes (counting past the stretch up to the per-lane capacity,
// so the caller can run the step again with more room).
// What bounds it on the card: latency. Each row that runs is a handful of
// group barriers over its live lanes, and the rows run in sequence; bytes
// moved (the token table once in and out, the rows once) are far below that.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "prog.cuh"

namespace {

constexpr int kMaxRefs = 16;
constexpr int kMaxCapLanes = 32;
constexpr int kMaxRegs = 16;
// a block's threads: the row group rarely needs more than a few warps, and
// a block of 256 leaves a thread up to 255 registers (1,024 spilled)
constexpr int kMaxThreads = 256;
constexpr int8_t kCurrent = 0;
constexpr int8_t kTimer = 2;

// descriptor layout (int64 words), written by PatternProgram.scan_desc
enum { H_S, H_R, H_SEQ, H_FWD, H_WITHIN, H_WORDS };
enum {
  SL_NATOMS, SL_ATOM0, SL_ATOM1, SL_LOGICAL, SL_MIN, SL_MAX, SL_PERSIST, SL_COUNT, SL_WITHIN,
  SL_BLOCK_FIRST, SL_DKIND, SL_WAIT_REF, SL_BOTH_ABSENT, SL_TRAIL_MIN0, SL_WORDS
};
enum { RF_SLOT, RF_ABSENT, RF_WAIT, RF_CAP, RF_NPROG, RF_PROG, RF_WORDS };
enum { LOG_NONE, LOG_AND, LOG_OR };
enum { DK_NONE, DK_ABSENT, DK_BOTH, DK_ONE };
// condition programs (core/pattern.py): value types, opcodes and the
// interpreter are csrc/prog.cuh's; a capture read is its OP_OPERAND
constexpr long long kNone = 1 << 20;  // an un-indexed capture read

struct CapLane {
  const void* in;   // [T, cap] token-table lane before the step
  void* out;        // [T, cap] after it (the kernel works on it in place)
  const void* ev;   // [B] the event column a capture writes (null: none)
  void* emit;       // [cap_out, cap] emission lane (null: not emitted)
  void* stage;      // [T, cap] staging of copies into allocated lanes
  long long null_bits;  // a cleared element (0 for timestamps)
  int ref;
  int size;         // bytes per element: 1, 4 or 8
  int is_ts;        // the ref's timestamps (a capture writes the row's ts)
};

struct ScanArgs {
  const long long* desc;
  int desc_words, T, B, n_cl, n_regs, cap_out, smem;
  const bool* active_in;
  bool* active_out;
  const int32_t* slot_in;
  int32_t* slot_out;
  const long long* start_in;
  long long* start_out;
  const long long* entry_in;
  long long* entry_out;
  const bool* fwd_in;  // null without a fwd lane
  bool* fwd_out;
  const int32_t* n_in[kMaxRefs];
  int32_t* n_out[kMaxRefs];
  int32_t* out_nref[kMaxRefs];
  CapLane cl[kMaxCapLanes];
  const long long* ts;
  const int8_t* kind;
  const bool* valid;
  const bool* rmask;  // [R, B]
  const void* reg[kMaxRegs];
  long long* out_ts;
  bool* out_valid;
  int32_t* out_n;
  const bool* ovf_in;
  bool* ovf_out;
  const long long* timer_seen;
  void* scratch;  // the per-lane arrays when they do not fit shared memory
  // keyed mode (K37, inside a partition): block q runs slot q's [T] lanes
  // of a [P*T] table (lanes q*T ..), over its member rows merged with the
  // TIMER rows in row order, into its emission stretch
  int keyed;
  const bool* used;          // [P] slots that run
  const int32_t* rowlist;    // [B] member rows by (slot, row)
  const int32_t* slot_start; // [P + 1]
  const int32_t* timers;     // the TIMER rows, in row order
  const int32_t* info;       // info[3]: the TIMER row count
  const long long* off;      // [P] each slot's stretch in the emission lanes
  const int32_t* cap;        // [P] its rows
  int32_t* n_slot;           // [P] out: the slot's emissions (up to cap_out)
  const long long* seen_slot;  // [P] each slot's timer_seen
  int opt;                     // OPT_* bits
};

// the kernel's options (ScanArgs.opt; core/pattern.py SCAN_OPT): the passes
// run over the live-lane list (else over every lane), the row group is sized
// to the live count (else the whole block), and rows that cannot change the
// table are skipped. Any subset gives the same result.
enum { OPT_LIST = 1, OPT_NARROW = 2, OPT_SKIP = 4 };

// per-lane arrays, in this order: int64 start, entry, dl, dl2, st_start;
// int32 slot, dest, list, n[R], st_n[R]; uint32 words inl[nw], bits[nw],
// fpre[nw + 2] (nw = ceil(T / 32)); bytes active, fwd, match, adv, cnt,
// touch, stouch, fire, fire2, dmask (core/pattern.py scan_lane_bytes sizes
// the caller's global scratch the same way)
__host__ __device__ inline long long lane_bytes(int T, int R) {
  const long long t8 = ((long long)T + 7) / 8 * 8;
  const long long nw = ((long long)T + 31) / 32;
  return t8 * (5 * 8 + (3 + 2 * R) * 4 + 10) + 4 * (3 * nw + 2);
}

struct Ctx {
  const ScanArgs* A;
  // this block's capture lanes and emission lanes (keyed: at its slot's
  // token lanes and emission stretch), the JAX emission capacity and the
  // rows this block may store
  const CapLane* cl;
  long long* out_ts;
  bool* out_valid;
  long long eo;  // the emission stretch's first row
  int cap_out, cap_write;
  const long long* d;
  int T, S, R, B, last, nw;
  bool* active;
  bool* fwd;
  int32_t* slot;
  long long* start;
  long long* entry;
  int32_t* nb;  // the refs' counts, ref r at nb + r * t8
  uint8_t *match, *adv, *cnt, *touch, *stouch, *fire, *fire2, *dmask;
  int32_t *dest, *list;
  // inl: the lanes in the list; bits: the active lanes (allocation); fpre:
  // the free lanes before each word
  uint32_t *inl, *bits, *fpre;
  long long *dl, *dl2, *st_start;
  int32_t* stnb;  // their staging, as nb
  long long t8;   // the lanes rounded up to 8, the per-lane arrays' stride
  int* ws;
  long long* wsl;
  int* s_out_n;
  int* s_ovf;
  int* s_nl;  // the list's length
  // what the rows since the last compaction did (F_*; written by thread 0)
  int* s_flags;
  // the row group: nthr threads, the first nthr / 32 warps of the block
  int nthr, opt;
  bool has_dk;  // some slot has a deadline
  __device__ __forceinline__ int32_t* nr(int r) const { return nb + r * t8; }
  __device__ __forceinline__ int32_t* stn(int r) const { return stnb + r * t8; }
  __device__ __forceinline__ int32_t* onref(int r) const { return A->out_nref[r] + eo; }
};

// a row deactivated lanes (the list wants compacting), or changed the
// table some other way (touch set, a lane's start or slot moved)
enum { F_DIRTY = 1, F_BUSY = 2 };

__device__ __forceinline__ void mark(const Ctx& c, int f) {
  if (threadIdx.x == 0) *c.s_flags |= f;
}

// a thread's place in the row group (the group is the block's first warps)
__device__ __forceinline__ int tid_() { return (int)threadIdx.x; }

__device__ __forceinline__ const long long* slotd(const Ctx& c, int p) {
  return c.d + H_WORDS + (long long)p * SL_WORDS;
}
__device__ __forceinline__ const long long* refd(const Ctx& c, int r) {
  return c.d + H_WORDS + (long long)c.S * SL_WORDS + (long long)r * RF_WORDS;
}

__device__ __forceinline__ unsigned long long ld_bits(const void* base, long long i, int size) {
  switch (size) {
    case 1: return ((const uint8_t*)base)[i];
    case 4: return ((const uint32_t*)base)[i];
    default: return ((const unsigned long long*)base)[i];
  }
}
__device__ __forceinline__ void st_bits(void* base, long long i, int size, unsigned long long v) {
  switch (size) {
    case 1: ((uint8_t*)base)[i] = (uint8_t)v; break;
    case 4: ((uint32_t*)base)[i] = (uint32_t)v; break;
    default: ((unsigned long long*)base)[i] = v; break;
  }
}

// the event value a capture of lane l writes at row b
__device__ __forceinline__ unsigned long long ev_bits(const Ctx& c, int l, int b, long long ts) {
  const CapLane& L = c.cl[l];
  return L.is_ts ? (unsigned long long)ts : ld_bits(L.ev, b, L.size);
}

// ---- the row group's synchronisation: one warp syncs as a warp, more warps
// on named barrier 1 over just their threads (the other warps wait at
// barrier 0 until the group is resized) ----------------------------------------

__device__ __forceinline__ void gsync(const Ctx& c) {
  if (c.nthr == 32) __syncwarp();
  else asm volatile("bar.sync 1, %0;" ::"r"(c.nthr) : "memory");
}

// a barrier that returns whether any group thread's v is set
__device__ __forceinline__ int g_any(const Ctx& c, int v) {
  if (c.nthr == 32) {
    __syncwarp();
    return __any_sync(kFull, v);
  }
  v = __any_sync(kFull, v);
  if ((tid_() & 31) == 0) c.ws[tid_() >> 5] = v;
  gsync(c);
  int r = 0;
  for (int w = 0; w < (c.nthr >> 5); ++w) r |= c.ws[w];
  gsync(c);
  return r;
}

// exclusive prefix sum of one int per group thread in thread order
__device__ __forceinline__ int g_excl_sum(const Ctx& c, int v, int* total) {
  const int lane = tid_() & 31, warp = tid_() >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (c.nthr == 32) {
    *total = __shfl_sync(kFull, incl, 31);
    return incl - v;
  }
  if (lane == 31) c.ws[warp] = incl;
  gsync(c);
  int before = 0, all = 0;
  for (int w = 0; w < (c.nthr >> 5); ++w) {
    if (w < warp) before += c.ws[w];
    all += c.ws[w];
  }
  gsync(c);
  *total = all;
  return incl - v + before;
}

// the group's minimum of one int64 per thread
__device__ __forceinline__ long long g_min64(const Ctx& c, long long v) {
  for (int dd = 16; dd > 0; dd >>= 1) {
    const long long y = __shfl_down_sync(kFull, v, dd);
    v = y < v ? y : v;
  }
  v = __shfl_sync(kFull, v, 0);
  if (c.nthr == 32) return v;
  if ((tid_() & 31) == 0) c.wsl[tid_() >> 5] = v;
  gsync(c);
  long long m = c.wsl[0];
  for (int w = 1; w < (c.nthr >> 5); ++w) m = c.wsl[w] < m ? c.wsl[w] : m;
  gsync(c);
  return m;
}

// ---- the live-lane list: every lane that is active or holds a fwd mark,
// plus the lanes that left them since the last compaction, in ascending
// order (OPT_LIST off: every lane). The passes below run over it ---------------

__device__ __forceinline__ int nlist(const Ctx& c) { return *c.s_nl; }

__device__ __forceinline__ uint32_t word_mask(const Ctx& c, int w) {
  const int rem = c.T - w * 32;
  return rem >= 32 ? 0xffffffffu : (1u << rem) - 1u;
}

// the list rebuilt from the inl words (a popcount prefix over them)
__device__ __forceinline__ void list_from_bits(const Ctx& c) {
  int run = 0;
  for (int base = 0; base < c.nw; base += c.nthr) {
    const int w = base + tid_();
    const uint32_t x = w < c.nw ? c.inl[w] : 0u;
    int total;
    int at = run + g_excl_sum(c, __popc(x), &total);
    for (uint32_t y = x; y != 0u; y &= y - 1u) c.list[at++] = w * 32 + __ffs(y) - 1;
    run += total;
  }
  if (tid_() == 0) *c.s_nl = run;
  gsync(c);
}

// drop the lanes that are neither active nor fwd-marked
__device__ __forceinline__ void compact(const Ctx& c) {
  if (!(c.opt & OPT_LIST)) return;
  int drop = 0;
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int t = c.list[i];
    if (!c.active[t] && !(c.fwd != nullptr && c.fwd[t])) {
      atomicAnd(&c.inl[t >> 5], ~(1u << (t & 31)));
      drop = 1;
    }
  }
  if (g_any(c, drop)) list_from_bits(c);
}

// a lane that was not in the list joins it: its row scratch as the passes
// so far left an inactive lane's (nothing matched, touched or fired)
__device__ __forceinline__ bool join(const Ctx& c, int d) {
  if ((c.inl[d >> 5] >> (d & 31)) & 1u) return false;
  c.match[d] = c.adv[d] = c.cnt[d] = c.touch[d] = c.stouch[d] = c.fire[d] = c.fire2[d] = 0;
  atomicOr(&c.inl[d >> 5], 1u << (d & 31));
  return true;
}

// exclusive rank of the set lanes of `m` in lane order (written to rank[t]
// for set lanes); returns the count. Every group thread calls it.
__device__ __forceinline__ int g_rank(const Ctx& c, const uint8_t* m, int32_t* rank) {
  int run = 0;
  const int nl = nlist(c);
  for (int base = 0; base < nl; base += c.nthr) {
    const int i = base + tid_();
    const int t = i < nl ? c.list[i] : 0;
    const int v = i < nl && m[t];
    int total;
    const int x = g_excl_sum(c, v, &total);
    if (v) rank[t] = run + x;
    run += total;
  }
  return run;
}

// ---- the token table: elementwise helpers ----------------------------------

// lane t of ref r's captures, cleared: count 0, timestamps 0, columns null
__device__ __forceinline__ void clear_ref(const Ctx& c, int r, int t) {
  c.nr(r)[t] = 0;
  const int w = (int)refd(c, r)[RF_CAP];
  for (int l = 0; l < c.A->n_cl; ++l) {
    const CapLane& L = c.cl[l];
    if (L.ref != r) continue;
    for (int k = 0; k < w; ++k) st_bits(L.out, (long long)t * w + k, L.size, L.null_bits);
  }
}

// _capture on lane t: the row's event into ref r's next occurrence
__device__ __forceinline__ void capture(const Ctx& c, int r, int t, int b, long long ts) {
  const int w = (int)refd(c, r)[RF_CAP];
  const int n = c.nr(r)[t];
  if (n < w) {
    const int pos = n < 0 ? 0 : n;
    for (int l = 0; l < c.A->n_cl; ++l) {
      const CapLane& L = c.cl[l];
      if (L.ref == r) st_bits(L.out, (long long)t * w + pos, L.size, ev_bits(c, l, b, ts));
    }
  }
  c.nr(r)[t] = n + 1;
}

// _clear_slot_caps on lane t: the slot's captures cleared, the slot clock
// restarted at `at`; slot 0 becomes virgin again
__device__ __forceinline__ void clear_slot(const Ctx& c, int p, int t, long long at) {
  const long long* sd = slotd(c, p);
  for (int a = 0; a < (int)sd[SL_NATOMS]; ++a) clear_ref(c, (int)sd[SL_ATOM0 + a], t);
  c.entry[t] = at;
  if (p == 0) c.start[t] = -1;
}

// ---- allocation, staging and copies (_alloc_lanes, _fork, _rearm_block,
// _arm_virgins) ---------------------------------------------------------------

// the free lanes (inactive, every one outside the list among them) counted
// per word into fpre; returns their number
__device__ __forceinline__ int free_words(const Ctx& c) {
  for (int w = tid_(); w < c.nw; w += c.nthr) c.bits[w] = 0u;
  gsync(c);
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int t = c.list[i];
    if (c.active[t]) atomicOr(&c.bits[t >> 5], 1u << (t & 31));
  }
  gsync(c);
  int run = 0;
  for (int base = 0; base < c.nw; base += c.nthr) {
    const int w = base + tid_();
    const int v = w < c.nw ? __popc(~c.bits[w] & word_mask(c, w)) : 0;
    int total;
    const int x = g_excl_sum(c, v, &total);
    if (w < c.nw) c.fpre[w] = run + x;
    run += total;
  }
  if (tid_() == 0) c.fpre[c.nw] = run;
  gsync(c);
  return run;
}

// the k-th free lane in ascending order (k < the free count)
__device__ __forceinline__ int kth_free(const Ctx& c, int k) {
  int lo = 0, hi = c.nw - 1;  // the last word w with fpre[w] <= k
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if ((int)c.fpre[mid] <= k) lo = mid;
    else hi = mid - 1;
  }
  uint32_t x = ~c.bits[lo] & word_mask(c, lo);
  for (int j = k - (int)c.fpre[lo]; j > 0; --j) x &= x - 1u;
  return lo * 32 + __ffs(x) - 1;
}

// dest[t] for each set lane of m: the rank-th free lane, or -1 (overflow)
__device__ __forceinline__ void alloc(const Ctx& c, const uint8_t* m) {
  const int nfree = free_words(c);
  g_rank(c, m, c.dest);
  int ovf = 0;
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int t = c.list[i];
    if (!m[t]) continue;
    const int k = c.dest[t];
    if (k < nfree) {
      c.dest[t] = kth_free(c, k);
    } else {
      c.dest[t] = -1;
      ovf = 1;
    }
  }
  if (g_any(c, ovf) && tid_() == 0) *c.s_ovf = 1;
}

// stage the set lanes of m that got a lane: start_ts, counts and captures;
// with adv_ref >= 0 each is staged as the advanced token of _capture (that
// ref's capture of row b written, start_ts set when virgin)
__device__ __forceinline__ void stage(const Ctx& c, const uint8_t* m, int adv_ref, int b, long long ts) {
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int t = c.list[i];
    if (!m[t] || c.dest[t] < 0) continue;
    const long long st = c.start[t];
    c.st_start[t] = adv_ref >= 0 && st < 0 ? ts : st;
    for (int r = 0; r < c.R; ++r) c.stn(r)[t] = c.nr(r)[t] + (r == adv_ref ? 1 : 0);
    for (int l = 0; l < c.A->n_cl; ++l) {
      const CapLane& L = c.cl[l];
      const int w = (int)refd(c, L.ref)[RF_CAP];
      for (int k = 0; k < w; ++k) {
        const long long j = (long long)t * w + k;
        st_bits(L.stage, j, L.size, ld_bits(L.out, j, L.size));
      }
      if (L.ref == adv_ref) {
        const int n = c.nr(adv_ref)[t];
        if (n < w) st_bits(L.stage, (long long)t * w + (n < 0 ? 0 : n), L.size, ev_bits(c, l, b, ts));
      }
    }
  }
}

enum { CP_FORK, CP_REARM, CP_VIRGIN };

// lane d written as a fresh virgin at slot new_slot (CP_VIRGIN's copy)
__device__ __forceinline__ void write_virgin(const Ctx& c, int d, int new_slot, long long at, bool fwd0) {
  c.active[d] = true;
  c.slot[d] = new_slot;
  c.start[d] = -1;
  c.entry[d] = at;
  if (c.fwd != nullptr) c.fwd[d] = fwd0;
  for (int r = 0; r < c.R; ++r) clear_ref(c, r, d);
  c.dmask[d] = 1;
}

// write the staged lanes into their allocated lanes. CP_FORK: at slot
// new_slot, start_ts staged, entry at (or dl[source] when use_dl), every
// ref copied; CP_REARM: at the block's first slot new_slot, start_ts
// staged when new_slot > 0 (else virgin), entry at, the refs of slots
// [new_slot, blk_last] cleared; CP_VIRGIN: at slot new_slot, virgin,
// every ref cleared, fwd = fwd0. dmask marks the written lanes, which then
// join the list.
__device__ __forceinline__ void copy_into(const Ctx& c, const uint8_t* m, int mode, int new_slot, int blk_last,
                          long long at, bool use_dl, bool fwd0) {
  for (int i = tid_(); i < nlist(c); i += c.nthr) c.dmask[c.list[i]] = 0;
  gsync(c);
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int s = c.list[i];
    if (!m[s]) continue;
    const int d = c.dest[s];
    if (d < 0) continue;
    if (mode == CP_VIRGIN) {
      write_virgin(c, d, new_slot, at, fwd0);
      continue;
    }
    c.active[d] = true;
    c.slot[d] = new_slot;
    c.start[d] = mode == CP_FORK ? c.st_start[s] : new_slot > 0 ? c.st_start[s] : -1;
    c.entry[d] = use_dl ? c.dl[s] : at;
    if (c.fwd != nullptr) c.fwd[d] = false;
    for (int r = 0; r < c.R; ++r) {
      const int rs = (int)refd(c, r)[RF_SLOT];
      if (mode == CP_REARM && rs >= new_slot && rs <= blk_last) {
        clear_ref(c, r, d);
        continue;
      }
      c.nr(r)[d] = c.stn(r)[s];
      const int w = (int)refd(c, r)[RF_CAP];
      for (int l = 0; l < c.A->n_cl; ++l) {
        const CapLane& L = c.cl[l];
        if (L.ref != r) continue;
        for (int k = 0; k < w; ++k)
          st_bits(L.out, (long long)d * w + k, L.size,
                  ld_bits(L.stage, (long long)s * w + k, L.size));
      }
    }
    c.dmask[d] = 1;
  }
  gsync(c);
  int joined = 0;
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int s = c.list[i];
    if (m[s] && c.dest[s] >= 0) joined |= join(c, c.dest[s]);
  }
  if (g_any(c, joined)) list_from_bits(c);
}

// _fork / _rearm_block / _arm_virgins of the set lanes of m
__device__ __forceinline__ void scatter(const Ctx& c, const uint8_t* m, int mode, int adv_ref, int b,
                        long long ts, int new_slot, int blk_last, long long at, bool use_dl,
                        bool fwd0) {
  alloc(c, m);
  if (mode != CP_VIRGIN) stage(c, m, adv_ref, b, ts);
  gsync(c);
  copy_into(c, m, mode, new_slot, blk_last, at, use_dl, fwd0);
}

// ---- emission (_write_emits) ---------------------------------------------------

// append the set lanes of m in lane order at out_n, up to cap_out (the
// overflow flag past it); the emission ts is `at`, or dl[t] with use_dl;
// with adv_ref >= 0 each lane is emitted as its advanced token (that ref's
// capture of row b written)
__device__ __forceinline__ void emit(const Ctx& c, const uint8_t* m, int adv_ref, int b, long long at,
                     bool use_dl) {
  const ScanArgs& A = *c.A;
  const int base = *c.s_out_n;
  const int total = g_rank(c, m, c.dest);
  int ovf = 0;
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int t = c.list[i];
    if (!m[t]) continue;
    const int o = base + c.dest[t];
    if (o >= c.cap_out) {
      ovf = 1;
      continue;
    }
    if (o >= c.cap_write) continue;  // counted, past the slot's stretch
    c.out_ts[o] = use_dl ? c.dl[t] : at;
    c.out_valid[o] = true;
    for (int r = 0; r < c.R; ++r) c.onref(r)[o] = c.nr(r)[t] + (r == adv_ref ? 1 : 0);
    for (int l = 0; l < A.n_cl; ++l) {
      const CapLane& L = c.cl[l];
      if (L.emit == nullptr) continue;
      const int w = (int)refd(c, L.ref)[RF_CAP];
      for (int k = 0; k < w; ++k)
        st_bits(L.emit, (long long)o * w + k, L.size, ld_bits(L.out, (long long)t * w + k, L.size));
      if (L.ref == adv_ref) {
        const int n = c.nr(adv_ref)[t];
        if (n < w) st_bits(L.emit, (long long)o * w + (n < 0 ? 0 : n), L.size, ev_bits(c, l, b, at));
      }
    }
  }
  if (g_any(c, ovf) && tid_() == 0) *c.s_ovf = 1;
  if (tid_() == 0) *c.s_out_n = base + total < c.cap_out ? base + total : c.cap_out;
  gsync(c);
}

// ---- condition programs ---------------------------------------------------------

__device__ __forceinline__ Val null_of(int ty) {
  Val v;
  v.i = 0;
  if (ty == TY_FLOAT) v.f = __int_as_float(0x7fc00000);
  else if (ty == TY_INT) v.i = (int)0x80000000;
  else if (ty == TY_LONG) v.i = (long long)0x8000000000000000ULL;
  return v;
}

// a condition program's reads on lane t at row b: row registers (typed by
// the instruction) and the token's captures, a capture read (ref, k, lane)
// with _synth_capture_cols' rules. It holds the few values it reads (not
// the context, which then stays in registers)
struct TokenRow {
  const ScanArgs* A;
  const CapLane* cl;
  const int32_t* nb;
  const long long* refs;  // the refs' descriptor rows
  long long t8;
  int t, b;
  __device__ __forceinline__ Val reg(const long long* ins) const {
    return load_elem(A->reg[ins[1]], b, (int)ins[2]);
  }
  __device__ __forceinline__ Val operand(const long long* ins) const {
    const int r = (int)ins[1], lane = (int)ins[3], ty = (int)ins[4];
    const long long k = ins[2];
    const int n = nb[r * t8 + t];
    Val v;
    if (lane < 0) {  // the arrival flag
      v.i = k == kNone ? n > 0 : k >= 0 ? n > k : n >= -k;
      return v;
    }
    const int w = (int)refs[(long long)r * RF_WORDS + RF_CAP];
    const void* base = cl[lane].out;
    if (k == kNone) return load_elem(base, (long long)t * w, ty);
    if (k >= w) return null_of(ty);
    if (k >= 0) return load_elem(base, (long long)t * w + k, ty);
    const long long idx = n + k;
    if (idx >= 0 && idx < w) return load_elem(base, (long long)t * w + idx, ty);
    return null_of(ty);
  }
};

// _eligible on lane t for slot p
__device__ __forceinline__ bool eligible(const Ctx& c, int p, int t) {
  const bool a = c.active[t];
  const int s = c.slot[t];
  bool skip = false;
  for (int q = p - 1; q >= 0; --q) {
    const long long* qd = slotd(c, q);
    if (!qd[SL_COUNT]) break;
    const int mn = (int)qd[SL_MIN];
    skip = skip || (a && s == q && c.nr((int)qd[SL_ATOM0])[t] >= (mn > 0 ? mn : 0));
    if (mn > 0) break;
  }
  if (c.fwd != nullptr) skip = skip && c.fwd[t];
  return (a && s == p) || skip;
}

// ---- one row (apply_event) --------------------------------------------------------

// the deadline blocks' common tail: emit / re-arm / consume / fork /
// advance the lanes of m at slot p, times dl[t]
__device__ __forceinline__ void fire_tail(const Ctx& c, int p, const uint8_t* m, bool consume_first) {
  mark(c, F_DIRTY | F_BUSY);
  const long long* sd = slotd(c, p);
  const bool persist = sd[SL_PERSIST] != 0;
  if (p == c.last) {
    emit(c, m, -1, 0, 0, true);
    for (int i = tid_(); i < nlist(c); i += c.nthr) {
      const int t = c.list[i];
      if (!m[t]) continue;
      if (persist) clear_slot(c, p, t, c.dl[t]);
      else c.active[t] = false;
    }
  } else if (persist) {
    scatter(c, m, CP_FORK, -1, 0, 0, p + 1, 0, 0, true, false);
    for (int i = tid_(); i < nlist(c); i += c.nthr) {
      const int t = c.list[i];
      if (m[t]) clear_slot(c, p, t, c.dl[t]);
    }
  } else {
    for (int i = tid_(); i < nlist(c); i += c.nthr) {
      const int t = c.list[i];
      if (!m[t]) continue;
      c.slot[t] = p + 1;
      c.entry[t] = c.dl[t];
    }
  }
  gsync(c);
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int t = c.list[i];
    c.touch[t] |= m[t];
  }
  gsync(c);
}

// the lanes' timestamps lane of ref r (the marker's latest arrival)
__device__ __forceinline__ const long long* ts_lane(const Ctx& c, int r) {
  for (int l = 0; l < c.A->n_cl; ++l)
    if (c.cl[l].is_ts && c.cl[l].ref == r) return (const long long*)c.cl[l].out;
  return nullptr;
}

// the deadlines of lane t at a both-absent slot p (r1, r2 its sides)
__device__ __forceinline__ void both_deadlines(const Ctx& c, int p, int t, long long* dl1,
                                               long long* dl2) {
  const long long* sd = slotd(c, p);
  const int r1 = (int)sd[SL_ATOM0], r2 = (int)sd[SL_ATOM1];
  const long long w1 = refd(c, r1)[RF_WAIT], w2 = refd(c, r2)[RF_WAIT];
  if (p == 0) {
    const long long l1 = ts_lane(c, r1)[(long long)t * refd(c, r1)[RF_CAP]];
    const long long l2 = ts_lane(c, r2)[(long long)t * refd(c, r2)[RF_CAP]];
    *dl1 = (c.entry[t] > l1 ? c.entry[t] : l1) + w1;
    *dl2 = (c.entry[t] > l2 ? c.entry[t] : l2) + w2;
  } else {
    *dl1 = c.entry[t] + w1;
    *dl2 = c.entry[t] + w2;
  }
}

__device__ __forceinline__ void deadlines(const Ctx& c, long long eff_now) {
  for (int p = 0; p < c.S; ++p) {
    const long long* sd = slotd(c, p);
    const int dk = (int)sd[SL_DKIND];
    if (dk == DK_NONE) continue;
    if (dk == DK_ABSENT) {
      const long long w = refd(c, (int)sd[SL_ATOM0])[RF_WAIT];
      int any = 0;
      for (int i = tid_(); i < nlist(c); i += c.nthr) {
        const int t = c.list[i];
        const long long dl = c.entry[t] + w;
        const bool f = c.active[t] && c.slot[t] == p && eff_now >= dl;
        c.fire[t] = f;
        c.dl[t] = dl;
        if (f && c.start[t] < 0) c.start[t] = dl;
        any |= f;
      }
      if (g_any(c, any)) fire_tail(c, p, c.fire, false);
    } else if (dk == DK_BOTH) {
      const int r1 = (int)sd[SL_ATOM0], r2 = (int)sd[SL_ATOM1];
      const bool persist = sd[SL_PERSIST] != 0;
      const bool is_and = sd[SL_LOGICAL] == LOG_AND;
      int any = 0, any2 = 0;
      for (int i = tid_(); i < nlist(c); i += c.nthr) {
        const int t = c.list[i];
        const bool at_p = c.active[t] && c.slot[t] == p;
        bool arr1 = c.nr(r1)[t] > 0, arr2 = c.nr(r2)[t] > 0;
        long long dl1, dl2;
        both_deadlines(c, p, t, &dl1, &dl2);
        if (p == 0) arr1 = arr2 = false;
        if (is_and) {
          const long long both = dl1 > dl2 ? dl1 : dl2;
          c.fire[t] = at_p && !arr1 && !arr2 && eff_now >= both;
          c.dl[t] = both;
          c.fire2[t] = 0;
        } else {
          const bool f1 = at_p && !arr1 && eff_now >= dl1;
          const bool f2 = at_p && !arr2 && eff_now >= dl2;
          if (persist) {
            c.fire[t] = f1;
            c.dl[t] = dl1;
            c.fire2[t] = f2;
            c.dl2[t] = dl2;
          } else {
            c.fire[t] = f1 || f2;
            c.dl[t] = f1 ? dl1 : dl2;
            c.fire2[t] = 0;
          }
        }
        any |= c.fire[t];
        any2 |= c.fire2[t];
      }
      if (g_any(c, any)) fire_tail(c, p, c.fire, false);
      if (g_any(c, any2)) {
        for (int i = tid_(); i < nlist(c); i += c.nthr) {
          const int t = c.list[i];
          c.dl[t] = c.dl2[t];
          c.fire[t] = c.fire2[t];
        }
        gsync(c);
        fire_tail(c, p, c.fire, false);
      }
    } else {  // DK_ONE: a logical element with one waiting absent side
      const int ab = (int)sd[SL_WAIT_REF];
      const long long w = refd(c, ab)[RF_WAIT];
      const bool is_or = sd[SL_LOGICAL] == LOG_OR;
      int any = 0;
      for (int i = tid_(); i < nlist(c); i += c.nthr) {
        const int t = c.list[i];
        const long long dl = c.entry[t] + w;
        bool f = c.active[t] && c.slot[t] == p && eff_now >= dl;
        if (is_or) {
          f = f && !(c.nr(ab)[t] > 0);
        } else {
          for (int a = 0; a < (int)sd[SL_NATOMS]; ++a) {
            const int r = (int)sd[SL_ATOM0 + a];
            if (!refd(c, r)[RF_ABSENT]) f = f && c.nr(r)[t] > 0;
          }
        }
        c.fire[t] = f;
        c.dl[t] = dl;
        any |= f;
      }
      if (g_any(c, any)) fire_tail(c, p, c.fire, true);
    }
  }
}

// the earliest time a deadline of the live lanes can fire (a lower bound:
// a both-absent slot's earlier side), or LLONG_MAX
__device__ __forceinline__ long long earliest_deadline(const Ctx& c) {
  long long best = 0x7fffffffffffffffLL;
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int t = c.list[i];
    const int p = c.slot[t];
    if (!c.active[t] || p < 0 || p >= c.S) continue;
    const long long* sd = slotd(c, p);
    const int dk = (int)sd[SL_DKIND];
    long long dl;
    if (dk == DK_NONE) continue;
    if (dk == DK_ABSENT) {
      dl = c.entry[t] + refd(c, (int)sd[SL_ATOM0])[RF_WAIT];
    } else if (dk == DK_BOTH) {
      long long dl1, dl2;
      both_deadlines(c, p, t, &dl1, &dl2);
      dl = dl1 < dl2 ? dl1 : dl2;
    } else {
      dl = c.entry[t] + refd(c, (int)sd[SL_WAIT_REF])[RF_WAIT];
    }
    best = dl < best ? dl : best;
  }
  return g_min64(c, best);
}

// one atom (ref r of slot p) against the row
__device__ __forceinline__ int match_atom(const Ctx& c, int p, int r, int b, long long ts, long long eff_now) {
  const ScanArgs& A = *c.A;
  const long long* sd = slotd(c, p);
  const long long* rd = refd(c, r);
  const bool is_count = sd[SL_COUNT] != 0, persist = sd[SL_PERSIST] != 0;
  const int logical = (int)sd[SL_LOGICAL];
  const int w = (int)rd[RF_CAP];
  const long long mx = sd[SL_MAX];
  // eligibility and the condition programs
  int any = 0;
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int t = c.list[i];
    bool e = eligible(c, p, t) && !c.touch[t];
    if (is_count && w > 0 && mx > 0) e = e && !(c.slot[t] == p && c.nr(r)[t] >= mx);
    const long long* pr = c.d + rd[RF_PROG];
    for (int k = 0; k < (int)rd[RF_NPROG] && e; ++k) {
      const int len = (int)pr[0];
      e = run_prog(pr + 1, len, TokenRow{c.A, c.cl, c.nb, refd(c, 0), c.t8, t, b}).i != 0;
      pr += 1 + 5 * len;
    }
    c.match[t] = e;
    any |= e;
  }
  if (!g_any(c, any)) return 0;
  mark(c, F_DIRTY | F_BUSY);

  if (rd[RF_ABSENT]) {
    const long long wait = rd[RF_WAIT];
    const bool both = sd[SL_BOTH_ABSENT] != 0;
    if (wait >= 0 && (logical == LOG_OR || both)) {
      // an arrival inside the window: a capture marker, not a kill
      for (int i = tid_(); i < nlist(c); i += c.nthr) {
        const int t = c.list[i];
        const bool mark = c.match[t] && ts <= c.entry[t] + wait;
        if (mark) {
          if (p == 0 && both) {
            c.nr(r)[t] = 1;
            for (int l = 0; l < A.n_cl; ++l) {
              const CapLane& L = c.cl[l];
              if (L.ref != r || !L.is_ts) continue;
              long long* col = (long long*)L.out + (long long)t * w;
              if (ts > *col) *col = ts;
            }
          } else {
            capture(c, r, t, b, ts);
          }
        }
        c.stouch[t] |= mark;
      }
      gsync(c);
      return 1;
    }
    for (int i = tid_(); i < nlist(c); i += c.nthr) {
      const int t = c.list[i];
      bool m = c.match[t];
      if (wait >= 0) m = m && ts <= c.entry[t] + wait;
      if (p == 0 && wait >= 0) {
        const bool rearm = m && c.start[t] < 0;
        if (m && !rearm) c.active[t] = false;
        if (rearm) clear_slot(c, p, t, ts);
      } else if (m) {
        c.active[t] = false;
      }
      c.stouch[t] |= m;
    }
    gsync(c);
    return 1;
  }

  // the advanced token (capture, slot p, start) — completion and count
  const long long wab = sd[SL_WAIT_REF] >= 0 ? refd(c, (int)sd[SL_WAIT_REF])[RF_WAIT] : -1;
  int any_adv = 0, any_cnt = 0;
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int t = c.list[i];
    const bool m = c.match[t];
    bool adv = false, armed = false;
    if (m) {
      if (logical == LOG_OR) {
        adv = true;
      } else if (logical == LOG_AND) {
        adv = true;
        for (int a = 0; a < (int)sd[SL_NATOMS]; ++a) {
          const int r2 = (int)sd[SL_ATOM0 + a];
          if (refd(c, r2)[RF_ABSENT]) continue;
          adv = adv && (c.nr(r2)[t] + (r2 == r ? 1 : 0)) > 0;
        }
        if (wab >= 0) adv = adv && eff_now >= c.entry[t] + wab;
      } else if (is_count) {
        armed = sd[SL_MIN] >= 1 && c.nr(r)[t] + 1 == sd[SL_MIN];
        adv = p == c.last && sd[SL_MIN] >= 1 && armed;
      } else {
        adv = true;
      }
    }
    c.adv[t] = adv;
    c.cnt[t] = armed;
    any_adv |= adv;
    any_cnt |= armed;
  }
  any_adv = g_any(c, any_adv);
  any_cnt = g_any(c, any_cnt);
  const int blk_first = (int)sd[SL_BLOCK_FIRST];
  if (p == c.last) {
    if (any_adv) emit(c, c.adv, r, b, ts, false);
    // the staying lanes take the advanced token; the emitting ones are
    // consumed (forced at a count slot)
    for (int i = tid_(); i < nlist(c); i += c.nthr) {
      const int t = c.list[i];
      if (c.match[t] && !c.adv[t]) {
        capture(c, r, t, b, ts);
        c.slot[t] = p;
        if (c.start[t] < 0) c.start[t] = ts;
      }
      if (c.adv[t] && (!persist || is_count)) c.active[t] = false;
    }
    gsync(c);
    if (blk_first >= 0 && any_adv) {
      scatter(c, c.adv, CP_REARM, r, b, ts, blk_first, p, ts, false, false);
      for (int i = tid_(); i < nlist(c); i += c.nthr) {
        const int t = c.list[i];
        c.touch[t] |= c.dmask[t];
      }
      gsync(c);
    }
  } else if (persist && !is_count) {
    bool arrived_min0 = false;
    if (any_adv) {
      scatter(c, c.adv, CP_FORK, r, b, ts, p + 1, 0, ts, false, false);
      arrived_min0 = slotd(c, p + 1)[SL_TRAIL_MIN0] != 0;
    } else {
      for (int i = tid_(); i < nlist(c); i += c.nthr) c.dmask[c.list[i]] = 0;
    }
    for (int i = tid_(); i < nlist(c); i += c.nthr) {
      const int t = c.list[i];
      if (c.match[t] && !c.adv[t]) {
        capture(c, r, t, b, ts);
        c.slot[t] = p;
        if (c.start[t] < 0) c.start[t] = ts;
      }
      c.touch[t] |= c.dmask[t];
    }
    gsync(c);
    if (arrived_min0) {  // _arrival_effects: a trailing min-0 count emits at once
      emit(c, c.dmask, -1, b, ts, false);
      for (int i = tid_(); i < nlist(c); i += c.nthr) {
        const int t = c.list[i];
        if (c.dmask[t]) c.active[t] = false;
      }
      gsync(c);
    }
  } else {
    for (int i = tid_(); i < nlist(c); i += c.nthr) {
      const int t = c.list[i];
      if (!c.match[t]) continue;
      capture(c, r, t, b, ts);
      c.slot[t] = p;
      if (c.start[t] < 0) c.start[t] = ts;
      if (c.adv[t]) {
        c.slot[t] = p + 1;
        c.entry[t] = ts;
      }
    }
    gsync(c);
    if (any_adv && slotd(c, p + 1)[SL_TRAIL_MIN0]) {
      emit(c, c.adv, -1, b, ts, false);
      for (int i = tid_(); i < nlist(c); i += c.nthr) {
        const int t = c.list[i];
        if (c.adv[t]) c.active[t] = false;
      }
      gsync(c);
    }
    if (blk_first >= 0 && any_adv) {
      scatter(c, c.adv, CP_REARM, -1, b, ts, blk_first, p, ts, false, false);
      for (int i = tid_(); i < nlist(c); i += c.nthr) {
        const int t = c.list[i];
        c.touch[t] |= c.dmask[t];
      }
      gsync(c);
    }
  }
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int t = c.list[i];
    c.stouch[t] |= c.match[t];
    if (persist && logical != LOG_NONE && c.adv[t]) clear_slot(c, p, t, ts);
  }
  gsync(c);
  if (persist && is_count && sd[SL_MIN] >= 1 && !c.d[H_SEQ] && any_cnt) {
    const long long* s0 = slotd(c, p);
    scatter(c, c.cnt, CP_VIRGIN, -1, b, ts, p, 0, ts, false,
            s0[SL_COUNT] && s0[SL_MIN] == 0);
  }
  return 1;
}

// the within kills at time ts (a kill is sticky and monotone in ts: the
// kills of skipped rows come due at the next row that runs, at the largest
// ts seen since), with the row's touch cleared; returns the latest time
// the surviving lanes pass without a kill
__device__ __forceinline__ long long kills(const Ctx& c, long long ts) {
  const long long gw = c.d[H_WITHIN];
  long long horizon = 0x7fffffffffffffffLL;
  int any = 0;
  for (int i = tid_(); i < nlist(c); i += c.nthr) {
    const int t = c.list[i];
    c.touch[t] = 0;
    const long long st = c.start[t];
    if (st < 0 || !c.active[t]) continue;
    long long w = gw;
    const int s = c.slot[t];
    if (s >= 0 && s < c.S) {
      const long long sw = slotd(c, s)[SL_WITHIN];
      if (sw >= 0 && (w < 0 || sw < w)) w = sw;
    }
    if (w < 0) continue;
    if (ts - st > w) {
      c.active[t] = false;
      any = 1;
    } else if (st + w < horizon) {
      horizon = st + w;
    }
  }
  if (g_any(c, any)) mark(c, F_DIRTY | F_BUSY);
  return g_min64(c, horizon);
}

// a sequence's start state: a fresh virgin in the first free lane
__device__ __forceinline__ void virgin_one(const Ctx& c, long long ts, bool fwd0) {
  mark(c, F_BUSY);
  const int nfree = free_words(c);
  if (tid_() == 0) {
    if (nfree > 0) {
      const int d = kth_free(c, 0);
      for (int i = 0; i < nlist(c); ++i) c.dmask[c.list[i]] = 0;
      write_virgin(c, d, 0, ts, fwd0);
      c.dest[0] = join(c, d) ? 1 : 0;
    } else {
      *c.s_ovf = 1;
      c.dest[0] = 0;
    }
  }
  gsync(c);
  if (c.dest[0]) list_from_bits(c);
  gsync(c);
}

// one row, after its kills (run_rows runs them, or knows them to be none
// and touch clear); min_dl: a lower bound of the live lanes' deadlines
// (LLONG_MAX: unknown), below which no deadline block can fire
__device__ __forceinline__ void apply_row(const Ctx& c, int b, long long timer_seen,
                                          long long min_dl) {
  const ScanArgs& A = *c.A;
  const long long ts = A.ts[b];
  const int8_t kind = A.kind[b];
  const bool is_cur = kind == kCurrent;
  const long long eff_now = ts > timer_seen ? ts : timer_seen;
  const bool can_fire = kind == kTimer || is_cur;


  // a sequence's start state: a fresh virgin when none is pending at slot 0
  const long long* s0 = slotd(c, 0);
  if (c.d[H_SEQ] && s0[SL_PERSIST] && is_cur) {
    const long long mx0 = s0[SL_MAX] > 0 ? s0[SL_MAX] : (1LL << 30);
    int pend = 0;
    for (int i = tid_(); i < nlist(c); i += c.nthr) {
      const int t = c.list[i];
      const bool at0 = c.active[t] && c.slot[t] == 0;
      pend |= at0 && (c.start[t] < 0 || (s0[SL_COUNT] && c.nr((int)s0[SL_ATOM0])[t] < mx0));
    }
    if (!g_any(c, pend)) virgin_one(c, ts, s0[SL_COUNT] && s0[SL_MIN] == 0);
  }

  // a sequence's virgin above may hold a deadline min_dl does not know
  if (can_fire && c.has_dk && (eff_now >= min_dl || c.d[H_SEQ] || min_dl == 0x7fffffffffffffffLL))
    deadlines(c, eff_now);

  if (is_cur) {
    // the atoms; stouch is clear between slots, so a slot none of whose
    // atoms matched leaves touch as it was
    for (int p = c.last; p >= 0; --p) {
      const long long* sd = slotd(c, p);
      int matched = 0;
      for (int a = 0; a < (int)sd[SL_NATOMS]; ++a) {
        const int r = (int)sd[SL_ATOM0 + a];
        if (!A.rmask[(long long)r * c.B + b]) continue;
        matched |= match_atom(c, p, r, b, ts, eff_now);
      }
      if (!matched) continue;
      for (int i = tid_(); i < nlist(c); i += c.nthr) {
        const int t = c.list[i];
        c.touch[t] |= c.stouch[t];
        c.stouch[t] = 0;
      }
      gsync(c);
    }
    if (c.d[H_SEQ]) {  // strictness: an unconsumed event kills the started tokens
      int any = 0;
      for (int i = tid_(); i < nlist(c); i += c.nthr) {
        const int t = c.list[i];
        if (c.active[t] && !c.touch[t] && c.start[t] >= 0) {
          c.active[t] = false;
          any = 1;
        }
      }
      if (g_any(c, any)) mark(c, F_DIRTY | F_BUSY);
    }
    if (c.d[H_FWD]) {  // the fwd contest: per count slot, the oldest chain wins
      mark(c, F_DIRTY | F_BUSY);
      for (int i = tid_(); i < nlist(c); i += c.nthr) {
        const int t = c.list[i];
        c.fire2[t] = c.fwd[t] && c.active[t] && c.start[t] < 0;
      }
      for (int q = 0; q < c.S; ++q) {
        const long long* qd = slotd(c, q);
        if (!qd[SL_COUNT]) continue;
        const int rq = (int)qd[SL_ATOM0];
        const int mn = qd[SL_MIN] > 0 ? (int)qd[SL_MIN] : 0;
        long long best = 1LL << 62;
        for (int i = tid_(); i < nlist(c); i += c.nthr) {
          const int t = c.list[i];
          const bool cand = c.active[t] && c.slot[t] == q && c.touch[t] && c.nr(rq)[t] >= mn &&
                            c.start[t] >= 0;
          const long long key = cand ? c.start[t] * c.T + t : (1LL << 62);
          best = key < best ? key : best;
        }
        best = g_min64(c, best);
        if (best < (1LL << 62) && tid_() == 0) c.fire2[(int)(best - (best / c.T) * c.T)] = 1;
        gsync(c);
      }
      for (int i = tid_(); i < nlist(c); i += c.nthr) {
        const int t = c.list[i];
        c.fwd[t] = c.fire2[t];
      }
      gsync(c);
    }
  }
}

// whether row b, applied to the table as it stands, would change nothing
// (a quiet row): not a TIMER row, no kill (ts within the kills' horizon),
// no deadline due, and no eligible lane meeting the conditions of an atom
// whose row mask is set (touch is clear at such a row). A sequence and a
// pattern with a fwd lane have no quiet CURRENT row (the callers check).
__device__ __forceinline__ bool row_quiet(const Ctx& c, int b, long long seen, long long horizon,
                                          long long min_dl) {
  const ScanArgs& A = *c.A;
  if (!A.valid[b]) return true;
  const int8_t kind = A.kind[b];
  if (kind == kTimer) return false;
  const long long ts = A.ts[b];
  if (ts > horizon) return false;
  if (kind != kCurrent) return true;
  if ((ts > seen ? ts : seen) >= min_dl) return false;
  const int nl = nlist(c);
  for (int p = c.last; p >= 0; --p) {
    const long long* sd = slotd(c, p);
    const bool is_count = sd[SL_COUNT] != 0;
    const long long mx = sd[SL_MAX];
    for (int a = 0; a < (int)sd[SL_NATOMS]; ++a) {
      const int r = (int)sd[SL_ATOM0 + a];
      if (!A.rmask[(long long)r * c.B + b]) continue;
      const long long* rd = refd(c, r);
      const int w = (int)rd[RF_CAP];
      for (int i = 0; i < nl; ++i) {
        const int t = c.list[i];
        bool e = eligible(c, p, t);
        if (is_count && w > 0 && mx > 0) e = e && !(c.slot[t] == p && c.nr(r)[t] >= mx);
        const long long* pr = c.d + rd[RF_PROG];
        for (int k = 0; k < (int)rd[RF_NPROG] && e; ++k) {
          const int len = (int)pr[0];
          e = run_prog(pr + 1, len, TokenRow{c.A, c.cl, c.nb, refd(c, 0), c.t8, t, b}).i != 0;
          pr += 1 + 5 * len;
        }
        if (e) return false;
      }
    }
  }
  return true;
}

// the live count up to which the rows ahead are tested in parallel, one a
// group thread, for quiet rows to skip
constexpr int kLookaheadLanes = 64;

// where the row group stands between two resizes
struct Cursor {
  int i, k;             // the next row (keyed: the member and TIMER cursors)
  long long kill_ts;    // the largest ts of the rows skipped since the last run row
  int done;
};

// the row group's walk over the rows from the cursor, until the rows end
// (cur->done) or the live count asks for another group width (*s_W)
__device__ __forceinline__ void run_rows(const Ctx& shared_ctx, Cursor* cur, int* s_W, int m_lo,
                                         int m_hi, int n_tim, long long seen) {
  // the group's own copy, held in registers across the inlined passes (the
  // byte lanes' stores could alias a context in memory)
  const Ctx c = shared_ctx;
  const ScanArgs& A = *c.A;
  const bool skip_ok = (c.opt & OPT_SKIP) != 0;
  const bool cur_skip = skip_ok && !c.d[H_SEQ] && !c.d[H_FWD];
  const bool has_dk = c.has_dk;
  // min_dl is kept (recomputed after a row that changed the table) when
  // rows may be skipped and some slot has a deadline
  const bool track_dl = skip_ok && has_dk;
  int i = cur->i, k = cur->k;
  long long kill_ts = cur->kill_ts;
  long long min_dl = track_dl ? earliest_deadline(c) : 0x7fffffffffffffffLL;
  // the kills' horizon: F_BUSY forces the first row's kill pass
  long long horizon = 0x7fffffffffffffffLL;
  if (tid_() == 0) *c.s_flags |= F_BUSY;
  const int nwarps = (int)(blockDim.x >> 5);
  int noisy = -1;  // a row ahead known not to be quiet
  // the lookahead backs off while it finds no quiet rows: it waits
  // la_wait processed rows, doubling up to 8
  int la_wait = 0, la_level = 0;
  while (true) {
    int b;
    bool member = true;  // keyed: b is the slot's member row (else a TIMER row)
    if (A.keyed) {
      if (i >= m_hi && k >= n_tim) break;
      const int rm = i < m_hi ? A.rowlist[i] : 0x7fffffff;
      const int rt = k < n_tim ? A.timers[k] : 0x7fffffff;
      member = rm < rt;
      b = member ? rm : rt;
    } else {
      if (i >= A.B) break;
      b = i;
      if (!A.valid[b]) {
        ++i;
        continue;
      }
    }
    const long long ts = A.ts[b];
    const int8_t kind = A.kind[b];
    if (skip_ok && kind != kTimer) {
      bool skip = kind != kCurrent;  // a row that only kills
      if (!skip && cur_skip) {
        bool any = false;
        for (int r = 0; r < c.R && !any; ++r) any = A.rmask[(long long)r * c.B + b];
        skip = !any && (ts > seen ? ts : seen) < min_dl;
      }
      if (skip) {
        kill_ts = ts > kill_ts ? ts : kill_ts;
        if (member) ++i;
        else ++k;
        continue;
      }
    }
    gsync(c);
    const int fl = *c.s_flags;
    gsync(c);
    if (tid_() == 0) *c.s_flags = 0;
    if (fl & F_DIRTY) compact(c);
    if (c.opt & OPT_NARROW) {
      const int nl = nlist(c);
      int need = (nl + 31) / 32;
      need = need < 1 ? 1 : need > nwarps ? nwarps : need;
      const int W = c.nthr >> 5;
      if (need > W || (need < W && nl <= 32 * W - 48)) {
        if (tid_() == 0) *s_W = need;
        break;
      }
    }
    // the row's kills first, when a kill may be due or touch may be set:
    // then the lanes ahead are as the row's later steps will see them
    const long long kts = ts > kill_ts ? ts : kill_ts;
    const bool do_kills = (fl & F_BUSY) || kts > horizon;
    if (do_kills) {
      horizon = kills(c, kts);
      kill_ts = -0x7fffffffffffffffLL - 1;
    }
    if (cur_skip && !A.keyed && i != noisy && la_wait > 0) {
      --la_wait;
    } else if (cur_skip && !A.keyed && i != noisy && nlist(c) <= kLookaheadLanes) {
      // the rows ahead, one a group thread: skip the quiet ones before the
      // first that is not
      const int bj = i + tid_();
      const bool q = bj < A.B && row_quiet(c, bj, seen, horizon, min_dl);
      const long long first = g_min64(c, q ? (long long)c.nthr : (long long)tid_());
      if (first < c.nthr) noisy = i + (int)first;
      la_level = first >= 2 ? 0 : la_level * 2 + 1 < 8 ? la_level * 2 + 1 : 8;
      la_wait = la_level;
      if (first > 0) {
        // the largest ts skipped, as ~min(~ts)
        const long long kt = q && A.valid[bj] && tid_() < first ? A.ts[bj] : kill_ts;
        kill_ts = ~g_min64(c, ~(kt > kill_ts ? kt : kill_ts));
        i += (int)first;
        continue;
      }
    }
    apply_row(c, b, seen, min_dl);
    kill_ts = -0x7fffffffffffffffLL - 1;
    if (member) ++i;
    else ++k;
    if (track_dl) {
      gsync(c);
      if (*c.s_flags & F_BUSY) min_dl = earliest_deadline(c);
    }
  }
  const bool ended = A.keyed ? (i >= m_hi && k >= n_tim) : i >= A.B;
  if (ended && kill_ts != -0x7fffffffffffffffLL - 1) {
    kills(c, kill_ts);
    kill_ts = -0x7fffffffffffffffLL - 1;
  }
  if (tid_() == 0) {
    cur->i = i;
    cur->k = k;
    cur->kill_ts = kill_ts;
    cur->done = ended;
  }
}

// MIN_BLOCKS: the blocks an SM should hold at once. K16's one block takes
// every register it wants (1); K37's block a slot shares the SM with the
// others (4: at most 64 registers a thread)
template <int MIN_BLOCKS>
__global__ void __launch_bounds__(kMaxThreads, MIN_BLOCKS)
scan_kernel(const __grid_constant__ ScanArgs A) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ws[32];
  __shared__ long long wsl[32];
  __shared__ int s_out_n, s_ovf, s_nl, s_W, s_flags;
  __shared__ Cursor s_cur;
  __shared__ long long desc[1024];
  __shared__ CapLane s_cl[kMaxCapLanes];
  const int T = A.T;
  // keyed: block q runs slot q, when the slot is used and some row reaches
  // it (any other slot keeps its lanes, copied by the caller)
  const int q = A.keyed ? (int)blockIdx.x : 0;
  int m_lo = 0, m_hi = 0, n_tim = 0;
  if (A.keyed) {
    m_lo = A.slot_start[q];
    m_hi = A.slot_start[q + 1];
    n_tim = A.info[3];
    if (!A.used[q] || (m_hi == m_lo && n_tim == 0)) return;
  }
  for (int i = threadIdx.x; i < A.desc_words; i += blockDim.x) desc[i] = A.desc[i];
  __syncthreads();
  // the context every thread reads, in shared memory (uniform over the
  // block: no copy of it in each thread's local memory)
  __shared__ Ctx s_ctx;
  Ctx c;
  c.A = &A;
  c.d = desc;
  c.T = T;
  c.S = (int)desc[H_S];
  c.R = (int)desc[H_R];
  c.B = A.B;
  c.last = c.S - 1;
  c.nw = (T + 31) / 32;
  c.ws = ws;
  c.wsl = wsl;
  c.s_out_n = &s_out_n;
  c.s_ovf = &s_ovf;
  c.s_nl = &s_nl;
  c.s_flags = &s_flags;
  c.has_dk = false;
  for (int p = 0; p < c.S; ++p) c.has_dk = c.has_dk || slotd(c, p)[SL_DKIND] != DK_NONE;
  c.opt = A.opt;
  // this block's lanes: slot q's token lanes start at q * T, its emission
  // stretch at off[q]
  const long long tb = (long long)q * T;
  const long long eo = A.keyed ? A.off[q] : 0;
  if (threadIdx.x < (unsigned)A.n_cl) {
    CapLane L = A.cl[threadIdx.x];
    const long long w = refd(c, L.ref)[RF_CAP];
    const long long shift = tb * w * L.size;
    L.in = (const unsigned char*)L.in + shift;
    L.out = (unsigned char*)L.out + shift;
    L.stage = (unsigned char*)L.stage + shift;
    if (L.emit != nullptr) L.emit = (unsigned char*)L.emit + eo * w * L.size;
    s_cl[threadIdx.x] = L;
  }
  c.cl = s_cl;
  c.out_ts = A.out_ts + eo;
  c.out_valid = A.out_valid + eo;
  c.eo = eo;
  c.cap_out = A.cap_out;
  c.cap_write = A.keyed ? A.cap[q] : A.cap_out;
  // the per-lane arrays: shared memory, or global scratch (one region a
  // block)
  unsigned char* p = A.smem ? smem
                            : (unsigned char*)A.scratch + (A.keyed ? q * lane_bytes(T, c.R) : 0);
  const long long t8 = ((long long)T + 7) / 8 * 8;
  long long* q64 = (long long*)p;
  c.start = q64;
  c.entry = q64 + t8;
  c.dl = q64 + 2 * t8;
  c.dl2 = q64 + 3 * t8;
  c.st_start = q64 + 4 * t8;
  int32_t* q32 = (int32_t*)(q64 + 5 * t8);
  c.slot = q32;
  c.dest = q32 + t8;
  c.list = q32 + 2 * t8;
  c.t8 = t8;
  c.nb = q32 + 3 * t8;
  c.stnb = q32 + (3 + c.R) * t8;
  uint32_t* qw = (uint32_t*)(q32 + (3 + 2 * c.R) * t8);
  c.inl = qw;
  c.bits = qw + c.nw;
  c.fpre = qw + 2 * c.nw;
  uint8_t* q8 = (uint8_t*)(qw + 3 * c.nw + 2);
  c.active = (bool*)q8;
  c.fwd = A.fwd_in != nullptr ? (bool*)(q8 + t8) : nullptr;
  c.match = q8 + 2 * t8;
  c.adv = q8 + 3 * t8;
  c.cnt = q8 + 4 * t8;
  c.touch = q8 + 5 * t8;
  c.stouch = q8 + 6 * t8;
  c.fire = q8 + 7 * t8;
  c.fire2 = q8 + 8 * t8;
  c.dmask = q8 + 9 * t8;
  c.nthr = blockDim.x;
  for (int w = threadIdx.x; w < c.nw; w += blockDim.x) c.inl[w] = 0u;
  if (threadIdx.x == 0) s_ctx = c;
  __syncthreads();

  // the token table in: control lanes to the working arrays, capture lanes
  // to their output copies; the list's first members
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    c.active[t] = A.active_in[tb + t];
    c.slot[t] = A.slot_in[tb + t];
    c.start[t] = A.start_in[tb + t];
    c.entry[t] = A.entry_in[tb + t];
    if (c.fwd != nullptr) c.fwd[t] = A.fwd_in[tb + t];
    for (int r = 0; r < c.R; ++r) c.nr(r)[t] = A.n_in[r][tb + t];
    c.stouch[t] = 0;
    if (!(c.opt & OPT_LIST) || c.active[t] || (c.fwd != nullptr && c.fwd[t]))
      atomicOr(&c.inl[t >> 5], 1u << (t & 31));
  }
  for (int l = 0; l < A.n_cl; ++l) {
    const CapLane& L = c.cl[l];
    const long long n = (long long)T * refd(c, L.ref)[RF_CAP];
    for (long long i = threadIdx.x; i < n; i += blockDim.x)
      st_bits(L.out, i, L.size, ld_bits(L.in, i, L.size));
  }
  if (threadIdx.x == 0) {
    s_out_n = A.keyed ? 0 : *A.out_n;
    s_ovf = A.keyed ? 0 : *A.ovf_in;
    s_cur = Cursor{A.keyed ? m_lo : 0, 0, -0x7fffffffffffffffLL - 1, 0};
    s_flags = 0;
  }
  __syncthreads();
  list_from_bits(s_ctx);
  const int nwarps = (int)(blockDim.x >> 5);
  if (threadIdx.x == 0) {
    const int need = (s_nl + 31) / 32;
    s_W = !(c.opt & OPT_NARROW) ? nwarps : need < 1 ? 1 : need > nwarps ? nwarps : need;
  }
  __syncthreads();
  const long long seen = A.keyed ? A.seen_slot[q] : *A.timer_seen;
  // the rows: the first s_W warps walk them; the others wait at barrier 0
  // until the group asks for another width or the rows end
  while (true) {
    const int W = s_W;
    const bool done = s_cur.done != 0;
    if (threadIdx.x == 0) s_ctx.nthr = W * 32;
    __syncthreads();
    if (done) break;
    if ((int)(threadIdx.x >> 5) < W) run_rows(s_ctx, &s_cur, &s_W, m_lo, m_hi, n_tim, seen);
    __syncthreads();
  }
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    A.active_out[tb + t] = c.active[t];
    A.slot_out[tb + t] = c.slot[t];
    A.start_out[tb + t] = c.start[t];
    A.entry_out[tb + t] = c.entry[t];
    if (c.fwd != nullptr) A.fwd_out[tb + t] = c.fwd[t];
    for (int r = 0; r < c.R; ++r) A.n_out[r][tb + t] = c.nr(r)[t];
  }
  if (threadIdx.x == 0) {
    if (A.keyed) {
      A.n_slot[q] = s_out_n;
      if (s_ovf) *A.ovf_out = true;
    } else {
      *A.out_n = s_out_n;
      *A.ovf_out = s_ovf != 0;
    }
  }
}

// the launch of either mode: one block, or one a slot
int launch_scan(ScanArgs& A, int grid, cudaStream_t stream) {
  int threads = (A.T + 31) / 32 * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads < 32 ? 32 : threads;
  // the descriptor's R is the refs count the lane arrays are sized by
  int R = 0;
  while (R < kMaxRefs && A.n_in[R] != nullptr) ++R;
  const long long bytes = A.smem ? lane_bytes(A.T, R) : 0;
  auto kernel = A.keyed ? scan_kernel<4> : scan_kernel<1>;
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  // one block (K16): no more shared memory than it needs, the rest stays L1
  // for the interpreter's stack, the capture lanes and the rows (one warp's
  // loads are latency-bound); a block a slot (K37): as much as holds most
  // blocks at once
  const int pct = A.keyed ? 100 : (int)((bytes + 16 * 1024) * 100 / (228 * 1024)) + 1;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout, pct > 100 ? 100 : pct);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, (size_t)bytes, stream>>>(A);
  return (int)cudaGetLastError();
}

int fill_args(ScanArgs& A, const long long* desc, int desc_words, int T, int B, int R,
              const bool* active_in, bool* active_out, const int32_t* slot_in, int32_t* slot_out,
              const long long* start_in, long long* start_out, const long long* entry_in,
              long long* entry_out, const bool* fwd_in, bool* fwd_out,
              const int32_t* const* n_in, int32_t* const* n_out, int32_t* const* out_nref,
              int n_cl, const void* const* cl_in, void* const* cl_out, const void* const* cl_ev,
              void* const* cl_emit, void* const* cl_stage, const long long* cl_null,
              const int* cl_ref, const int* cl_size, const int* cl_is_ts,
              const long long* ts, const int8_t* kind, const bool* valid, const bool* rmask,
              int n_regs, const void* const* reg,
              long long* out_ts, bool* out_valid, int cap_out, int32_t* out_n,
              const bool* ovf_in, bool* ovf_out, const long long* timer_seen, void* scratch,
              int smem, int opt) {
  if (R > kMaxRefs || n_cl > kMaxCapLanes || n_regs > kMaxRegs || desc_words > 1024)
    return (int)cudaErrorInvalidValue;
  A = ScanArgs{};
  A.desc = desc;
  A.desc_words = desc_words;
  A.T = T;
  A.B = B;
  A.n_cl = n_cl;
  A.n_regs = n_regs;
  A.cap_out = cap_out;
  A.smem = smem;
  A.active_in = active_in;
  A.active_out = active_out;
  A.slot_in = slot_in;
  A.slot_out = slot_out;
  A.start_in = start_in;
  A.start_out = start_out;
  A.entry_in = entry_in;
  A.entry_out = entry_out;
  A.fwd_in = fwd_in;
  A.fwd_out = fwd_out;
  for (int r = 0; r < kMaxRefs; ++r) {
    A.n_in[r] = r < R ? n_in[r] : nullptr;
    A.n_out[r] = r < R ? n_out[r] : nullptr;
    A.out_nref[r] = r < R ? out_nref[r] : nullptr;
  }
  for (int l = 0; l < n_cl; ++l) {
    A.cl[l].in = cl_in[l];
    A.cl[l].out = cl_out[l];
    A.cl[l].ev = cl_ev[l];
    A.cl[l].emit = cl_emit[l];
    A.cl[l].stage = cl_stage[l];
    A.cl[l].null_bits = cl_null[l];
    A.cl[l].ref = cl_ref[l];
    A.cl[l].size = cl_size[l];
    A.cl[l].is_ts = cl_is_ts[l];
  }
  A.ts = ts;
  A.kind = kind;
  A.valid = valid;
  A.rmask = rmask;
  for (int i = 0; i < n_regs; ++i) A.reg[i] = reg[i];
  A.out_ts = out_ts;
  A.out_valid = out_valid;
  A.out_n = out_n;
  A.ovf_in = ovf_in;
  A.ovf_out = ovf_out;
  A.timer_seen = timer_seen;
  A.scratch = scratch;
  A.opt = opt;
  return 0;
}

}  // namespace

extern "C" {

// One scan step; see ScanArgs. desc: the device descriptor table (at most
// 1024 words). Host arrays describe the capture lanes (n_cl of them) and
// the row registers (n_regs). opt: the OPT_* bits (all set: the kernel's
// design; any subset gives the same result, for timing each alone).
int ps_scan(const long long* desc, int desc_words, int T, int B, int R,
            const bool* active_in, bool* active_out, const int32_t* slot_in, int32_t* slot_out,
            const long long* start_in, long long* start_out, const long long* entry_in,
            long long* entry_out, const bool* fwd_in, bool* fwd_out,
            const int32_t* const* n_in, int32_t* const* n_out, int32_t* const* out_nref,
            int n_cl, const void* const* cl_in, void* const* cl_out, const void* const* cl_ev,
            void* const* cl_emit, void* const* cl_stage, const long long* cl_null,
            const int* cl_ref, const int* cl_size, const int* cl_is_ts,
            const long long* ts, const int8_t* kind, const bool* valid, const bool* rmask,
            int n_regs, const void* const* reg,
            long long* out_ts, bool* out_valid, int cap_out, int32_t* out_n,
            const bool* ovf_in, bool* ovf_out, const long long* timer_seen, void* scratch,
            int smem, int opt, cudaStream_t stream) {
  ScanArgs A;
  const int e = fill_args(A, desc, desc_words, T, B, R, active_in, active_out, slot_in, slot_out,
                          start_in, start_out, entry_in, entry_out, fwd_in, fwd_out, n_in, n_out,
                          out_nref, n_cl, cl_in, cl_out, cl_ev, cl_emit, cl_stage, cl_null, cl_ref,
                          cl_size, cl_is_ts, ts, kind, valid, rmask, n_regs, reg, out_ts, out_valid,
                          cap_out, out_n, ovf_in, ovf_out, timer_seen, scratch, smem, opt);
  if (e != 0) return e;
  return launch_scan(A, 1, stream);
}

// K37, the keyed scan step inside a partition: the same arguments over a
// [P*T] token table (the in and out lanes, the capture lanes and their
// staging all [P*T]-long; slots the step does not run keep the out lanes
// the caller filled), one block a used slot over its member rows
// (rowlist / slot_start) and the TIMER rows (timers, info[3] of them) in
// row order. Slot q emits into the emission lanes at off[q], up to cap[q]
// rows stored and cap_out counted (n_slot[q], which the caller zeroes);
// ovf_out is set (never cleared) when a slot passes cap_out or a fork finds
// no lane. seen_slot [P]: each slot's timer_seen.
int pps_scan(const long long* desc, int desc_words, int T, int B, int R,
             const bool* active_in, bool* active_out, const int32_t* slot_in, int32_t* slot_out,
             const long long* start_in, long long* start_out, const long long* entry_in,
             long long* entry_out, const bool* fwd_in, bool* fwd_out,
             const int32_t* const* n_in, int32_t* const* n_out, int32_t* const* out_nref,
             int n_cl, const void* const* cl_in, void* const* cl_out, const void* const* cl_ev,
             void* const* cl_emit, void* const* cl_stage, const long long* cl_null,
             const int* cl_ref, const int* cl_size, const int* cl_is_ts,
             const long long* ts, const int8_t* kind, const bool* valid, const bool* rmask,
             int n_regs, const void* const* reg,
             long long* out_ts, bool* out_valid, int cap_out, bool* ovf_out, void* scratch,
             int smem, int P, const bool* used, const int32_t* rowlist,
             const int32_t* slot_start, const int32_t* timers, const int32_t* info,
             const long long* off, const int32_t* cap, int32_t* n_slot,
             const long long* seen_slot, int opt, cudaStream_t stream) {
  ScanArgs A;
  const int e = fill_args(A, desc, desc_words, T, B, R, active_in, active_out, slot_in, slot_out,
                          start_in, start_out, entry_in, entry_out, fwd_in, fwd_out, n_in, n_out,
                          out_nref, n_cl, cl_in, cl_out, cl_ev, cl_emit, cl_stage, cl_null, cl_ref,
                          cl_size, cl_is_ts, ts, kind, valid, rmask, n_regs, reg, out_ts, out_valid,
                          cap_out, nullptr, nullptr, ovf_out, nullptr, scratch, smem, opt);
  if (e != 0) return e;
  A.keyed = 1;
  A.used = used;
  A.rowlist = rowlist;
  A.slot_start = slot_start;
  A.timers = timers;
  A.info = info;
  A.off = off;
  A.cap = cap;
  A.n_slot = n_slot;
  A.seen_slot = seen_slot;
  return launch_scan(A, P, stream);
}


}  // extern "C"
