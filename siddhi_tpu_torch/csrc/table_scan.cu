// K24: a table's two routines that are sequential over probe rows, for
// Hopper (sm_90a).
//
// Replaces the lax.scan bodies of siddhi_tpu/core/table.py
// InMemoryTable.update (:524-577, with the primary-key rekey guard) and
// InMemoryTable.update_or_insert (:704-776), where each probe row, in order,
// sees the table as the earlier rows left it. The on-condition and the set
// values are table programs (csrc/prog.cuh): all of them back to back
// in `code`, program 0 the condition, program 1 + k the value of set k.
//   - The update without a guard has no dependency between slots: a slot's
//     last value depends only on its own lanes and the rows. One thread per
//     slot copies its lanes, walks every row in order (match, then every set
//     value evaluated before any is written) and stores the lanes back.
//   - The guarded update and the update-or-insert look across slots for
//     each row (the number of keys a row would change and whether another
//     slot holds the new key; whether any slot matched and the first free
//     slot), so one block walks the rows in order and its threads cover the
//     slots, with block reductions per row. An unmatched row of the
//     update-or-insert takes the first free slot (its columns, ts, valid and
//     seq = next, then next + 1), or sets the overflow flag when none is
//     free.
//   - The update-or-insert whose condition is one equality of a table lane
//     and a row register (eq_lane >= 0), with no set clause writing that
//     lane, runs by key groups instead (tg_*): rows of one key touch only the
//     slots of that key, and rows of different keys share only the free
//     slots and `next`. So the selected rows are hashed by key (their value
//     as raw_eq compares it; a null or NaN key is a group of its own) and
//     sorted by (group, row) in one block (a bitonic sort in shared memory);
//     each slot held at step start finds its group through the hash and
//     walks the group's rows in order; the first row of each group with no
//     such slot inserts, the inserting rows ranked in row order, rank k
//     taking the k-th free slot in ascending order and seq = next + k (a
//     rank at or past the free count sets the overflow flag); the inserted
//     slot then walks its group's later rows. That equals the serial walk
//     when every row inserts its own key (its key column equals its
//     register, or both are null), which the first launch checks: where
//     one does not, the launches after it return at once and the one-block
//     walk runs instead.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "prog.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 1024;

struct ScanArgs {
  const long long* code;
  int start[kMaxProgs];
  int len[kMaxProgs];
  int ty[kMaxProgs];       // result type of each program
  int n_sets;
  int set_lane[kMaxLanes];  // the lane set k writes
  int guard;               // the set whose column is the guarded key, or -1
  int eq_lane, eq_reg, eq_ty;  // the condition `lane == register` in type eq_ty, or -1
  int key_reg;  // the register a set clause writes into the key lane (key groups), or -1
  LaneSet regs;            // [B] row registers
  LaneSet lanes;           // [C] table columns, then ts (written in place)
  LaneSet ins;             // [B] the row's insert values per column (upsert)
};

// registers at row b; table lanes read from their arrays at slot c
__device__ __forceinline__ Val prog_at(const ScanArgs& A, int p, long long b, long long c) {
  RowSlot src{&A.regs, &A.lanes, b, c};
  return run_prog(A.code + 5LL * A.start[p], A.len[p], src);
}

// every set value at slot c for row b, then the writes
__device__ __forceinline__ void apply_sets(const ScanArgs& A, long long b, long long c) {
  Val v[kMaxLanes];
  for (int k = 0; k < A.n_sets; ++k) {
    const int l = A.set_lane[k];
    v[k] = convert(prog_at(A, 1 + k, b, c), A.ty[1 + k], A.lanes.ty[l]);
  }
  for (int k = 0; k < A.n_sets; ++k) {
    const int l = A.set_lane[k];
    store_elem(A.lanes.p[l], c, A.lanes.ty[l], v[k]);
  }
}

// the update without a guard: one thread per slot, every row in order
__global__ void update_slots_kernel(const __grid_constant__ ScanArgs A, const bool* rows, int B,
                                    int C, const bool* valid) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C || !valid[c]) return;
  Val lv[kMaxLanes];
  for (int l = 0; l < A.lanes.n; ++l) lv[l] = load_elem(A.lanes.p[l], c, A.lanes.ty[l]);
  bool dirty = false;
  for (int b = 0; b < B; ++b) {
    if (!rows[b]) continue;
    RowLocal src{&A.regs, lv, b};
    if (run_prog(A.code + 5LL * A.start[0], A.len[0], src).i == 0) continue;
    Val v[kMaxLanes];
    for (int k = 0; k < A.n_sets; ++k)
      v[k] = convert(run_prog(A.code + 5LL * A.start[1 + k], A.len[1 + k], src), A.ty[1 + k],
                     A.lanes.ty[A.set_lane[k]]);
    for (int k = 0; k < A.n_sets; ++k) lv[A.set_lane[k]] = v[k];
    dirty = true;
  }
  if (dirty)
    for (int k = 0; k < A.n_sets; ++k) {
      const int l = A.set_lane[k];
      store_elem(A.lanes.p[l], c, A.lanes.ty[l], lv[l]);
    }
}

__device__ __forceinline__ int block_sum(int v, int* ws) {
  int total;
  block_excl_sum(v, ws, &total);
  return total;
}

__device__ __forceinline__ int block_min(int v, int* ws) {
  int total;
  block_incl_min(v, ws, &total);
  return total;
}

// the guarded update: one block, the rows in order
// (1024 threads: at most 64 registers each, __launch_bounds__)
__global__ void __launch_bounds__(kBlock)
    update_guard_kernel(const __grid_constant__ ScanArgs A, const bool* rows, int B, int C,
                        const bool* valid, uint8_t* m, bool* conflict) {
  __shared__ int ws[32];
  __shared__ long long s_new;
  const int gl = A.set_lane[A.guard];
  const int gty = A.lanes.ty[gl];
  bool any_fail = false;
  for (int b = 0; b < B; ++b) {
    if (!rows[b]) continue;
    int n_changed = 0, first = 0x7fffffff;
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      const bool mc = valid[c] && prog_at(A, 0, b, c).i != 0;
      m[c] = mc;
      if (mc) {
        const Val v = convert(prog_at(A, 1 + A.guard, b, c), A.ty[1 + A.guard], gty);
        if (!raw_eq(v, load_elem(A.lanes.p[gl], c, gty), gty)) {
          ++n_changed;
          first = first < c ? first : c;
        }
      }
    }
    n_changed = block_sum(n_changed, ws);
    first = block_min(first, ws);
    bool fail = n_changed >= 2;
    if (n_changed == 1) {
      if (threadIdx.x == 0)
        s_new = convert(prog_at(A, 1 + A.guard, b, first), A.ty[1 + A.guard], gty).i;
      __syncthreads();
      Val nv;
      nv.i = s_new;
      int other = 0;
      for (int c = threadIdx.x; c < C; c += blockDim.x)
        other |= valid[c] && c != first && raw_eq(load_elem(A.lanes.p[gl], c, gty), nv, gty);
      fail = __syncthreads_or(other) != 0;
    }
    any_fail |= fail;
    if (!fail)
      for (int c = threadIdx.x; c < C; c += blockDim.x)
        if (m[c]) apply_sets(A, b, c);
    __syncthreads();
  }
  if (threadIdx.x == 0) *conflict = any_fail;
}

// the first free slot at or after `from` (C when none): every thread of the
// block calls it, after a barrier that orders the latest insert
__device__ int next_free(const bool* valid, int C, int from, int* ws) {
  for (int base = from; base < C; base += blockDim.x) {
    const int c = base + threadIdx.x;
    const int m = block_min(c < C && !valid[c] ? c : 0x7fffffff, ws);
    if (m < C) return m;
  }
  return C;
}

// the update-or-insert: one block, the rows in order. Free slots are only
// ever taken, so the first free slot is carried from row to row. An
// on-condition that is one equality of a table lane and a row register in
// one type (A.eq_lane >= 0) is matched by a plain compare of that lane,
// not the interpreter; a null register matches nothing. skip (null: none):
// nonzero when the key groups' launches did the step.
__global__ void __launch_bounds__(kBlock)
    upsert_kernel(const __grid_constant__ ScanArgs A, const bool* rows, int B, int C, bool* valid,
                  int64_t* seq, int64_t* next, const int64_t* ts_in, bool* overflow,
                  const int* skip) {
  __shared__ int ws[32];
  if (skip != nullptr && *skip) return;
  const int ts_lane = A.lanes.n - 1;
  long long nxt = *next;
  bool ovf = false;
  int first = next_free(valid, C, 0, ws);
  for (int b = 0; b < B; ++b) {
    if (!rows[b]) continue;
    int hit = 0;
    if (A.eq_lane >= 0) {
      const int ty = A.lanes.ty[A.eq_lane];
      const Val x = load_elem(A.regs.p[A.eq_reg], b, A.regs.ty[A.eq_reg]);
      if (not_null(x, A.eq_ty)) {
        const void* key = A.lanes.p[A.eq_lane];
        for (int c = threadIdx.x; c < C; c += blockDim.x) {
          if (valid[c] && raw_eq(load_elem(key, c, ty), x, ty)) {
            apply_sets(A, b, c);
            hit = 1;
          }
        }
      }
    } else {
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        if (valid[c] && prog_at(A, 0, b, c).i != 0) {
          apply_sets(A, b, c);
          hit = 1;
        }
      }
    }
    hit = __syncthreads_or(hit);
    if (!hit) {
      if (first < C) {
        if (threadIdx.x == 0) {
          for (int l = 0; l < ts_lane; ++l)
            store_elem(A.lanes.p[l], first, A.lanes.ty[l], load_elem(A.ins.p[l], b, A.ins.ty[l]));
          ((int64_t*)A.lanes.p[ts_lane])[first] = ts_in[b];
          valid[first] = true;
          seq[first] = nxt;
        }
        ++nxt;
        __syncthreads();
        first = next_free(valid, C, first + 1, ws);
      } else {
        ovf = true;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *next = nxt;
    *overflow = ovf;
  }
}


// ---- the update-or-insert by key groups (tg_*) ---------------------------------

constexpr int kGroupMaxRows = 1 << 14;  // rows of a step (14 bits of a sort key)
constexpr int kGThreads = 256;          // a block of the slot kernels
constexpr unsigned long long kEmpty = 0x8000000000000000ULL;  // the long null

// the group path's workspace, carved from one buffer (tsc_workspace's bytes)
struct GroupWork {
  int H, nblk;
  unsigned long long* hkey;  // [H] a group's key, kEmpty: free
  int *hfirst, *has_slot, *ins_slot, *gstart, *gend;  // [H] per group
  int *row_id, *srow, *freelist;  // [B]: a row's group (-1: null key, -2: not selected),
                                  // the rows by (group, row), the first free slots
  int* blk_free;  // [nblk] free slots of each slot block
  int* ok;        // the walk's precondition held
};

__host__ __device__ inline int group_hash_size(int B) {
  int h = 64;
  while (h < 2 * B) h <<= 1;
  return h;
}

__host__ __device__ inline long long group_work_bytes(int B, int C) {
  const long long H = group_hash_size(B), nblk = (C + kGThreads - 1) / kGThreads;
  return 8 * H + 4 * (5 * H + 3LL * B + nblk + 1);
}

__host__ __device__ inline GroupWork carve_group(void* base, int B, int C) {
  GroupWork g;
  g.H = group_hash_size(B);
  g.nblk = (C + kGThreads - 1) / kGThreads;
  g.hkey = (unsigned long long*)base;
  int* p = (int*)(g.hkey + g.H);
  g.hfirst = p;
  g.has_slot = p + g.H;
  g.ins_slot = p + 2 * g.H;
  g.gstart = p + 3 * g.H;
  g.gend = p + 4 * g.H;
  p += 5 * g.H;
  g.row_id = p;
  g.srow = p + B;
  g.freelist = p + 2 * B;
  g.blk_free = p + 3 * B;
  g.ok = g.blk_free + g.nblk;
  return g;
}

// a key as raw_eq compares it, as 64 bits: a float flushed, -0.0 as 0.0
__device__ __forceinline__ unsigned long long canon_key(Val v, int ty) {
  switch (ty) {
    case TY_FLOAT: {
      const float f = flush_subnormal(v.f);
      return f == 0.0f ? 0ull : (unsigned long long)__float_as_uint(f);
    }
    case TY_LONG: return (unsigned long long)v.i;
    case TY_BOOL: return v.i != 0;
    default: return (unsigned long long)(long long)(int)v.i;
  }
}

__device__ __forceinline__ unsigned hash_of(unsigned long long k, int H) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdULL;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ULL;
  k ^= k >> 33;
  return (unsigned)k & (unsigned)(H - 1);
}

// the group of key k, inserted when new
__device__ int hash_insert(const GroupWork& g, unsigned long long k) {
  unsigned h = hash_of(k, g.H);
  while (true) {
    const unsigned long long old = atomicCAS(&g.hkey[h], kEmpty, k);
    if (old == kEmpty || old == k) return (int)h;
    h = (h + 1) & (unsigned)(g.H - 1);
  }
}

// the group of key k, or -1
__device__ int hash_find(const GroupWork& g, unsigned long long k) {
  unsigned h = hash_of(k, g.H);
  while (true) {
    const unsigned long long x = g.hkey[h];
    if (x == k) return (int)h;
    if (x == kEmpty) return -1;
    h = (h + 1) & (unsigned)(g.H - 1);
  }
}

// 1. the rows' groups, the walk's precondition, the rows sorted by (group,
// row) and each group's run of them. One block; n_sort (a power of two >= B)
// ints of dynamic shared memory.
__global__ void __launch_bounds__(kBlock)
    tg_prepare(const __grid_constant__ ScanArgs A, const bool* rows, int B, int C, void* work,
               int n_sort) {
  extern __shared__ int skey[];
  const GroupWork g = carve_group(work, B, C);
  for (int h = threadIdx.x; h < g.H; h += blockDim.x) {
    g.hkey[h] = kEmpty;
    g.hfirst[h] = 0x7fffffff;
    g.has_slot[h] = 0;
    g.ins_slot[h] = -1;
    g.gstart[h] = g.gend[h] = 0;
  }
  __syncthreads();
  const int ty = A.lanes.ty[A.eq_lane];
  int bad = 0;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    int id = -2;
    if (rows[b]) {
      const Val x = load_elem(A.regs.p[A.eq_reg], b, A.regs.ty[A.eq_reg]);
      const Val v = load_elem(A.ins.p[A.eq_lane], b, A.ins.ty[A.eq_lane]);
      const bool mx = not_null(x, A.eq_ty), mv = not_null(v, ty);
      // the row's insert must hold its own key (or no key at all), and a
      // set clause writing the key lane must write the row's own key
      bad |= mx != mv || (mx && !raw_eq(x, v, ty));
      if (A.key_reg >= 0 && mx)
        bad |= !raw_eq(load_elem(A.regs.p[A.key_reg], b, A.regs.ty[A.key_reg]), x, ty);
      id = -1;
      if (mx) {
        id = hash_insert(g, canon_key(x, ty));
        atomicMin(&g.hfirst[id], b);
      }
    }
    g.row_id[b] = id;
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) *g.ok = !bad;
  if (bad) return;
  for (int i = threadIdx.x; i < n_sort; i += blockDim.x)
    skey[i] = i < B && g.row_id[i] >= 0 ? (g.row_id[i] << 14) | i : 0x7fffffff;
  __syncthreads();
  for (int k = 2; k <= n_sort; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n_sort; i += blockDim.x) {
        const int l = i ^ j;
        if (l <= i) continue;
        const int a = skey[i], b = skey[l];
        if ((a > b) == ((i & k) == 0)) {
          skey[i] = b;
          skey[l] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n_sort; i += blockDim.x) {
    const int key = skey[i];
    if (key == 0x7fffffff) continue;
    const int id = key >> 14;
    g.srow[i] = key & 0x3fff;
    if (i == 0 || (skey[i - 1] >> 14) != id) g.gstart[id] = i;
    if (i == n_sort - 1 || skey[i + 1] == 0x7fffffff || (skey[i + 1] >> 14) != id)
      g.gend[id] = i + 1;
  }
}

// 2. each slot held at step start walks its group's rows in order; the free
// slots counted per block
__global__ void __launch_bounds__(kGThreads)
    tg_slots(const __grid_constant__ ScanArgs A, int B, int C, const bool* valid, void* work) {
  const GroupWork g = carve_group(work, B, C);
  if (!*g.ok) return;
  const int c = blockIdx.x * kGThreads + threadIdx.x;
  int is_free = 0;
  if (c < C) {
    if (!valid[c]) {
      is_free = 1;
    } else {
      const int ty = A.lanes.ty[A.eq_lane];
      const Val k = load_elem(A.lanes.p[A.eq_lane], c, ty);
      const int id = not_null(k, ty) ? hash_find(g, canon_key(k, ty)) : -1;
      if (id >= 0) {
        g.has_slot[id] = 1;
        for (int i = g.gstart[id]; i < g.gend[id]; ++i) apply_sets(A, g.srow[i], c);
      }
    }
  }
  const int n = __syncthreads_count(is_free);
  if (threadIdx.x == 0) g.blk_free[blockIdx.x] = n;
}

// 3. the first B free slots in ascending order
__global__ void __launch_bounds__(kGThreads)
    tg_free(int B, int C, const bool* valid, void* work) {
  __shared__ int ws[32];
  const GroupWork g = carve_group(work, B, C);
  if (!*g.ok) return;
  int before = 0;
  for (int j = threadIdx.x; j < (int)blockIdx.x; j += kGThreads) before += g.blk_free[j];
  int total;
  block_excl_sum(before, ws, &total);
  const int c = blockIdx.x * kGThreads + threadIdx.x;
  const int is_free = c < C && !valid[c];
  int n;
  const int k = total + block_excl_sum(is_free, ws, &n);
  if (is_free && k < B) g.freelist[k] = c;
}

// 4. the inserts, ranked in row order, then each inserted slot walks its
// group's later rows. One block.
__global__ void __launch_bounds__(kBlock)
    tg_insert(const __grid_constant__ ScanArgs A, const bool* rows, int B, int C, bool* valid,
              int64_t* seq, int64_t* next, const int64_t* ts_in, bool* overflow, void* work) {
  __shared__ int ws[32];
  const GroupWork g = carve_group(work, B, C);
  if (!*g.ok) return;
  int part = 0;
  for (int j = threadIdx.x; j < g.nblk; j += blockDim.x) part += g.blk_free[j];
  int nfree;
  block_excl_sum(part, ws, &nfree);
  const int ts_lane = A.lanes.n - 1;
  const long long nxt = *next;
  int run = 0, ovf = 0;
  for (int base = 0; base < B; base += blockDim.x) {
    const int b = base + threadIdx.x;
    const int id = b < B ? g.row_id[b] : -2;
    const int ins = id == -1 || (id >= 0 && g.hfirst[id] == b && !g.has_slot[id]);
    int total;
    const int k = run + block_excl_sum(ins, ws, &total);
    if (ins) {
      if (k < nfree) {
        const int s = g.freelist[k];
        for (int l = 0; l < ts_lane; ++l)
          store_elem(A.lanes.p[l], s, A.lanes.ty[l], load_elem(A.ins.p[l], b, A.ins.ty[l]));
        ((int64_t*)A.lanes.p[ts_lane])[s] = ts_in[b];
        valid[s] = true;
        seq[s] = nxt + k;
        if (id >= 0) g.ins_slot[id] = s;
      } else {
        ovf = 1;
      }
    }
    run += total;
  }
  ovf = __syncthreads_or(ovf);
  if (threadIdx.x == 0) {
    *next = nxt + (run < nfree ? run : nfree);
    *overflow = ovf != 0;
  }
  for (int h = threadIdx.x; h < g.H; h += blockDim.x) {
    const int s = g.ins_slot[h];
    if (s < 0) continue;
    for (int i = g.gstart[h] + 1; i < g.gend[h]; ++i) apply_sets(A, g.srow[i], s);
  }
}

}  // namespace

extern "C" {

// upsert 0: the update (guard -1: none); 1: the update-or-insert.
// code: int64 [sum(len), 5], program p at rows start[p].. of length len[p]
// with result type ty[p]; program 0 the condition, 1 + k set k, writing lane
// set_lane[k]; eq_lane/eq_reg/eq_ty: program 0 is `lane == register` in
// type eq_ty (eq_lane -1: it is not). lanes: the n_lanes - 1 table columns
// then ts, copies of the state written in place. valid/seq/next: in place for the upsert (read only
// otherwise). ins: the upsert's n_lanes - 1 insert columns [B] in the lanes'
// dtypes, ts_in [B]. scratch: uint8 [C]. flag: the conflict (update) or
// overflow (upsert) flag. work: tsc_workspace(B, C) bytes for the
// update-or-insert by key groups (null: the one-block walk; only with
// eq_lane >= 0 and B <= 16,384); key_reg: the register that a set clause
// writes, unchanged, into the key lane, or -1 when no set clause writes it
// (a set clause writing anything else into it takes the walk).
int tsc_scan(int upsert, const long long* code, const int* start, const int* len, const int* ty,
             int n_progs, int n_regs, void* const* regs, const int* reg_ty, int n_lanes,
             void* const* lanes, const int* lane_ty, const int* set_lane, int guard,
             int eq_lane, int eq_reg, int eq_ty, const bool* rows, int B, int C, bool* valid,
             int64_t* seq, int64_t* next,
             void* const* ins, const int64_t* ts_in, uint8_t* scratch, bool* flag, void* work,
             int key_reg, cudaStream_t stream) {
  if (n_progs > kMaxProgs || n_regs > kMaxLanes || n_lanes > kMaxLanes || n_progs < 1)
    return (int)cudaErrorInvalidValue;
  ScanArgs A;
  A.code = code;
  for (int p = 0; p < kMaxProgs; ++p) {
    A.start[p] = p < n_progs ? start[p] : 0;
    A.len[p] = p < n_progs ? len[p] : 0;
    A.ty[p] = p < n_progs ? ty[p] : 0;
  }
  A.n_sets = n_progs - 1;
  for (int k = 0; k < kMaxLanes; ++k) A.set_lane[k] = k < A.n_sets ? set_lane[k] : 0;
  A.guard = guard;
  A.eq_lane = eq_lane;
  A.eq_reg = eq_reg;
  A.eq_ty = eq_ty;
  A.key_reg = key_reg;
  fill_lanes(&A.regs, n_regs, regs, reg_ty);
  fill_lanes(&A.lanes, n_lanes, lanes, lane_ty);
  fill_lanes(&A.ins, upsert ? n_lanes - 1 : 0, ins, lane_ty);
  if (upsert && work != nullptr) {
    bool own_lane = false;
    for (int k = 0; k < A.n_sets; ++k) own_lane = own_lane || A.set_lane[k] == eq_lane;
    if (eq_lane < 0 || own_lane != (key_reg >= 0) || B < 1 || B > kGroupMaxRows || C < 1)
      return (int)cudaErrorInvalidValue;
    int n_sort = 1;
    while (n_sort < B) n_sort <<= 1;
    const int smem = n_sort * (int)sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(tg_prepare, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int nblk = (C + kGThreads - 1) / kGThreads;
    tg_prepare<<<1, kBlock, smem, stream>>>(A, rows, B, C, work, n_sort);
    tg_slots<<<nblk, kGThreads, 0, stream>>>(A, B, C, valid, work);
    tg_free<<<nblk, kGThreads, 0, stream>>>(B, C, valid, work);
    tg_insert<<<1, kBlock, 0, stream>>>(A, rows, B, C, valid, seq, next, ts_in, flag, work);
    // the walk, when a row's insert did not hold its own key
    upsert_kernel<<<1, kBlock, 0, stream>>>(A, rows, B, C, valid, seq, next, ts_in, flag,
                                            carve_group(work, B, C).ok);
  } else if (upsert) {
    upsert_kernel<<<1, kBlock, 0, stream>>>(A, rows, B, C, valid, seq, next, ts_in, flag,
                                            nullptr);
  } else if (guard >= 0) {
    update_guard_kernel<<<1, kBlock, 0, stream>>>(A, rows, B, C, valid, scratch, flag);
  } else {
    cudaError_t err = cudaMemsetAsync(flag, 0, 1, stream);
    if (err != cudaSuccess) return (int)err;
    if (C > 0)
      update_slots_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0, stream>>>(A, rows, B, C,
                                                                                  valid);
  }
  return (int)cudaGetLastError();
}

// the bytes of tsc_scan's key-group workspace for B rows and C slots
long long tsc_workspace(int B, int C) { return group_work_bytes(B, C); }

}  // extern "C"
