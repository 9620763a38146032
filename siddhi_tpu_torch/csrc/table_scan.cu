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
// not the interpreter; a null register matches nothing.
__global__ void __launch_bounds__(kBlock)
    upsert_kernel(const __grid_constant__ ScanArgs A, const bool* rows, int B, int C, bool* valid,
                  int64_t* seq, int64_t* next, const int64_t* ts_in, bool* overflow) {
  __shared__ int ws[32];
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
// overflow (upsert) flag.
int tsc_scan(int upsert, const long long* code, const int* start, const int* len, const int* ty,
             int n_progs, int n_regs, void* const* regs, const int* reg_ty, int n_lanes,
             void* const* lanes, const int* lane_ty, const int* set_lane, int guard,
             int eq_lane, int eq_reg, int eq_ty, const bool* rows, int B, int C, bool* valid,
             int64_t* seq, int64_t* next,
             void* const* ins, const int64_t* ts_in, uint8_t* scratch, bool* flag,
             cudaStream_t stream) {
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
  fill_lanes(&A.regs, n_regs, regs, reg_ty);
  fill_lanes(&A.lanes, n_lanes, lanes, lane_ty);
  fill_lanes(&A.ins, upsert ? n_lanes - 1 : 0, ins, lane_ty);
  if (upsert) {
    upsert_kernel<<<1, kBlock, 0, stream>>>(A, rows, B, C, valid, seq, next, ts_in, flag);
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

}  // extern "C"
