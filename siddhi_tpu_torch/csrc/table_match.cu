// K23: a table's on-condition over every (probe row, slot) cell, reduced
// without the [B, C] mask, for Hopper (sm_90a).
//
// Replaces siddhi_tpu/core/table.py InMemoryTable.match (:431-457) with the
// reductions of its callers: _update_dense (:582-604, the last matching
// valid probe row per slot), delete (:459-467, any match per slot), and the
// `in <table>` condition of siddhi_tpu/core/executor.py (:367-396, any match
// per probe row). The JAX form materialises the [B, C] condition (10^9 cells
// at B = 8192, C = 10^5); here the condition is a table program
// (csrc/prog.cuh) evaluated per cell and reduced on the fly:
//   - per slot (writer, delete): one thread per slot copies the slot's lanes
//     once and walks the probe rows from the last, stopping at the first
//     match (the largest matching row);
//   - per row (`in`): one warp per probe row walks the slots 32 at a time
//     and stops at the first warp-wide match.
// An optional device flag (gate) turns the whole match off without a host
// read: every thread reads it first and reports no match when it is false
// (the dense update of an auto-indexed column runs only while the index
// holds duplicates, siddhi_tpu/core/table.py:503-516's lax.cond).
// The program's code sits in shared memory; the row registers are read by
// every thread of a warp at the same row (a broadcast load).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "prog.cuh"

namespace {

constexpr int kThreads = 256;
enum { MODE_WRITER = 0, MODE_DELETE = 1, MODE_IN = 2 };

__global__ void slot_kernel(const long long* code, int len, const __grid_constant__ LaneSet R,
                            const __grid_constant__ LaneSet L,
                            const bool* valid, const bool* rows, const bool* gate, int B,
                            int C, int mode, int32_t* w_out, bool* d_out) {
  extern __shared__ long long s_code[];
  load_code(code, len * 5, s_code);
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  int res = -1;
  if (valid[c] && (gate == nullptr || *gate)) {
    Val lv[kMaxLanes];
    for (int l = 0; l < L.n; ++l) lv[l] = load_elem(L.p[l], c, L.ty[l]);
    RowLocal src{&R, lv, 0};
    for (int b = B - 1; b >= 0; --b) {
      if (!rows[b]) continue;
      src.b = b;
      if (run_prog(s_code, len, src).i != 0) {
        res = b;
        break;
      }
    }
  }
  if (mode == MODE_WRITER) w_out[c] = res;
  else d_out[c] = res >= 0;
}

__global__ void row_kernel(const long long* code, int len, const __grid_constant__ LaneSet R,
                           const __grid_constant__ LaneSet L,
                           const bool* valid, const bool* gate, int B, int C, bool* out) {
  extern __shared__ long long s_code[];
  load_code(code, len * 5, s_code);
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= B) return;
  RowSlot src{&R, &L, w, 0};
  const bool on = gate == nullptr || *gate;
  bool found = false;
  for (int c0 = 0; on && c0 < C; c0 += 32) {
    const int c = c0 + lane;
    bool m = false;
    if (c < C && valid[c]) {
      src.c = c;
      m = run_prog(s_code, len, src).i != 0;
    }
    if (__any_sync(kFull, m)) {
      found = true;
      break;
    }
  }
  if (lane == 0) out[w] = found;
}

}  // namespace

extern "C" {

// mode 0: w_out int32 [C], the last row b with rows[b] matching slot c (or
// -1); mode 1: out bool [C], whether any such row matches slot c; mode 2:
// out bool [B], whether row b matches any valid slot (rows unused). A slot
// matches only when valid; nothing matches when gate (a device bool, or
// null: none) is false. code: int64 [len, 5].
int tm_match(const long long* code, int len, int n_regs, void* const* regs, const int* reg_ty,
             int n_lanes, void* const* lanes, const int* lane_ty, const bool* valid,
             const bool* rows, const bool* gate, int B, int C, int mode, void* out,
             cudaStream_t stream) {
  if (n_regs > kMaxLanes || n_lanes > kMaxLanes) return (int)cudaErrorInvalidValue;
  LaneSet R, L;
  fill_lanes(&R, n_regs, regs, reg_ty);
  fill_lanes(&L, n_lanes, lanes, lane_ty);
  const size_t smem = (size_t)(len > 0 ? len : 1) * 5 * sizeof(long long);
  if (mode == MODE_IN) {
    if (B > 0) {
      const long long threads = (long long)B * 32;
      row_kernel<<<(int)((threads + kThreads - 1) / kThreads), kThreads, smem, stream>>>(
          code, len, R, L, valid, gate, B, C, (bool*)out);
    }
  } else if (C > 0) {
    slot_kernel<<<(C + kThreads - 1) / kThreads, kThreads, smem, stream>>>(
        code, len, R, L, valid, rows, gate, B, C, mode, (int32_t*)out, (bool*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
