// K38-K39: a join step inside a partition, for Hopper (sm_90a).
//
// Replaces siddhi_tpu/core/partition.py PartitionedJoinQueryRuntime
// `_pstep_impl` (:214), which runs the join step (core/join.py:255-430
// `CompiledJoin.step` / `_assemble`) under `jax.vmap` over P partitions, and
// `_flatten` (:436), which orders the vmapped [P, cap] output by position
// first and slot second:
//   - K38 `pj_view`: each partition's ring in insertion order (core/
//     windows.py:438-452 `_view_perm` / `view` under the vmap). One block a
//     slot runs ring_view.cu's dense-index rank with the slot's own total:
//     a live seq lies in [total - W, total), so seq - (total - W) indexes a
//     [W] scratch row; one block scan compacts the live slots, a second
//     ranks the empty ones after them. join_probe.cu's `jp_partner_N` then
//     gathers a lane.
//   - K39 `pj_plan` + `pj_fill`: the probe compaction keyed by slot. The
//     pair mask is [R, W], each probe row against its own slot's W view
//     lanes (the vmap's [P, R, W] has only one slot's lanes live a row). A
//     warp a row counts its matches (plus the miss cell of an outer join
//     row that matched nothing); one block lists the member rows by (slot,
//     row) with partition.cuh's counting ranks, scans their counts into
//     each row's offset within its slot, keeps each slot's first `cap`
//     cells (the overflow flag is the OR over slots) and places the kept
//     cells by (position, slot) with partition.cuh's placement; a warp a
//     row then walks its row 32 columns at a time and writes each kept
//     cell's probe row and view element at its flattened place. The
//     output is compacted to the kept count (one host read), not the
//     vmap's [cap * P].
// What bounds it on the card: bytes, the R*W mask read twice and the
// output lanes written once (a few MB at R = 32,768, W = 50), but the one
// block that ranks and places the rows serialises ~R/1024 block scans;
// K38 is a few KB a slot, P blocks.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "partition.cuh"

namespace {

constexpr int kViewThreads = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// perm[q*W + k] = the ring element (q*W + j) shown at slot q's view row k;
// mask[q*W + k] = k < slot q's live elements. slot_at: a [P*W] scratch.
__global__ void __launch_bounds__(kViewThreads)
view_kernel(const int64_t* seq, const int64_t* total, int W, int32_t* slot_at, int32_t* perm,
            bool* mask) {
  __shared__ int ws[32];
  const int q = blockIdx.x, tid = threadIdx.x;
  const size_t row = (size_t)q * W;
  const int64_t* sq = seq + row;
  int32_t* sa = slot_at + row;
  int32_t* pm = perm + row;
  const long long base_seq = total[q] - W;
  for (int i = tid; i < W; i += kViewThreads) sa[i] = -1;
  __syncthreads();
  for (int j = tid; j < W; j += kViewThreads) {
    const long long s = sq[j];
    const long long i = s - base_seq;
    if (s >= 0 && i >= 0 && i < W) sa[i] = j;
  }
  __syncthreads();
  int live = 0, tot;
  for (int base = 0; base < W; base += kViewThreads) {
    const int i = base + tid;
    const int j = i < W ? sa[i] : -1;
    const int excl = block_excl_sum(j >= 0, ws, &tot);
    if (j >= 0) pm[live + excl] = (int32_t)(row + j);
    live += tot;
  }
  int empty = 0;
  for (int base = 0; base < W; base += kViewThreads) {
    const int j = base + tid;
    const bool hole = j < W && sq[j] < 0;
    const int excl = block_excl_sum(hole, ws, &tot);
    if (hole) pm[live + empty + excl] = (int32_t)(row + j);
    empty += tot;
  }
  for (int k = tid; k < W; k += kViewThreads) mask[row + k] = k < live;
}

__device__ __forceinline__ int member_slot(const bool* row_mask, const int32_t* row_slot, int P,
                                           int r) {
  const int sl = row_slot[r];
  return row_mask[r] && sl >= 0 && sl < P ? sl : -1;
}

// row_cnt[r]: the cells row r contributes (its matches, or its miss cell).
__global__ void count_kernel(const bool* pair, const bool* row_mask, const int32_t* row_slot,
                             int R, int W, int P, int outer, int32_t* row_cnt) {
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  if (member_slot(row_mask, row_slot, P, r) < 0) {
    if (lane == 0) row_cnt[r] = 0;
    return;
  }
  const bool* pr = pair + (size_t)r * W;
  int cnt = 0;
  for (int j = lane; j < W; j += 32) cnt += pr[j];
  for (int d = 16; d > 0; d >>= 1) cnt += __shfl_down_sync(kFull, cnt, d);
  if (lane == 0) row_cnt[r] = cnt + (outer && cnt == 0);
}

// One block: the member rows by (slot, row), each row's offset within its
// slot, each slot's kept count, the overflow flag and the (position, slot)
// placement of the kept cells; info[0] = kept cells, info[1] = the most of
// a slot, info[2] = member rows.
__global__ void __launch_bounds__(kRankThreads)
plan_kernel(const bool* row_mask, const int32_t* row_slot, int R, int P, int cap,
            const int32_t* row_cnt, int32_t* row_off, int32_t* rank, int32_t* rowlist,
            int32_t* slot_start, int32_t* prefix, int32_t* n_slot, int32_t* n_start,
            int32_t* pos_base, int32_t* oidx, int32_t* counters, int32_t* info, bool* overflow) {
  __shared__ RankSmem s;
  const int tid = threadIdx.x;
  const int C = member_rows(
      R, P, [&](int r) { return member_slot(row_mask, row_slot, P, r); }, rank, rowlist,
      slot_start, counters, s);
  int carry = 0;
  for (int base = 0; base < C; base += kRankThreads) {
    const int i = base + tid;
    int tot;
    const int e = block_excl_sum(i < C ? row_cnt[rowlist[i]] : 0, s.ws, &tot);
    if (i < C) prefix[i] = carry + e;
    carry += tot;
  }
  if (tid == 0) prefix[C] = carry;
  __syncthreads();
  for (int i = tid; i < C; i += kRankThreads) {
    const int r = rowlist[i];
    row_off[r] = prefix[i] - prefix[slot_start[row_slot[r]]];
  }
  bool ovf = false;
  for (int p = tid; p < P; p += kRankThreads) {
    const int tot = prefix[slot_start[p + 1]] - prefix[slot_start[p]];
    n_slot[p] = tot < cap ? tot : cap;
    ovf = ovf || tot > cap;
  }
  if (ovf) *overflow = true;
  __syncthreads();
  int maxn;
  const int kept = place_by_position(P, n_slot, n_start, pos_base, oidx, counters, &maxn, s);
  if (tid == 0) {
    info[0] = kept;
    info[1] = maxn;
    info[2] = C;
  }
}

// The output rows: a warp a member row writes its kept cells (probe row,
// view element slot*W + j or -1 for the miss) at their flattened places;
// rows past the kept count are padding (valid false, probe row 0, a null
// partner, slot P, their own first row).
__global__ void fill_kernel(const bool* pair, const bool* row_mask, const int32_t* row_slot,
                            int R, int W, int P, int outer, int cap, int rows,
                            const int32_t* row_off, const int32_t* n_start, const int32_t* oidx,
                            const int32_t* info, int32_t* pi, int32_t* pidx, int32_t* out_slot,
                            int32_t* out_first, bool* valid) {
  const int kept = info[0];
  const int gsize = gridDim.x * blockDim.x;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < rows; k += gsize) {
    valid[k] = k < kept;
    if (k >= kept) {
      pi[k] = 0;
      pidx[k] = -1;
      out_slot[k] = P;
      out_first[k] = k;
    }
  }
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int r = blockIdx.x * kWarps + (threadIdx.x >> 5); r < R; r += gridDim.x * kWarps) {
    const int sl = member_slot(row_mask, row_slot, P, r);
    if (sl < 0) continue;
    const int off = row_off[r];
    if (off >= cap) continue;
    const bool* pr = pair + (size_t)r * W;
    const int item = n_start[sl];
    const int first = oidx[item];  // the slot keeps a cell: its position 0 exists
    int run = 0;
    for (int j0 = 0; j0 < W && off + run < cap; j0 += 32) {
      const int j = j0 + lane;
      const bool bit = j < W && pr[j];
      const unsigned m = __ballot_sync(kFull, bit);
      const int k = off + run + __popc(m & below);
      if (bit && k < cap) {
        const int o = oidx[item + k];
        pi[o] = r;
        pidx[o] = sl * W + j;
        out_slot[o] = sl;
        out_first[o] = first;
      }
      run += __popc(m);
    }
    if (outer && lane == 0 && run == 0) {
      const int o = oidx[item + off];
      pi[o] = r;
      pidx[o] = -1;  // the miss column: a null partner
      out_slot[o] = sl;
      out_first[o] = first;
    }
  }
}

}  // namespace

extern "C" {

int pj_view(const int64_t* seq, const int64_t* total, int P, int W, int32_t* slot_at,
            int32_t* perm, bool* mask, cudaStream_t stream) {
  view_kernel<<<P, kViewThreads, 0, stream>>>(seq, total, W, slot_at, perm, mask);
  return (int)cudaGetLastError();
}

// The counts, ranks, offsets and placement of a keyed probe compaction
// (overflow zeroed by the caller).
int pj_plan(const bool* pair, const bool* row_mask, const int32_t* row_slot, int R, int W, int P,
            int outer, int cap, int32_t* row_cnt, int32_t* row_off, int32_t* rank,
            int32_t* rowlist, int32_t* slot_start, int32_t* prefix, int32_t* n_slot,
            int32_t* n_start, int32_t* pos_base, int32_t* oidx, int32_t* counters,
            int32_t* info, bool* overflow, cudaStream_t stream) {
  if (R > 0) {
    count_kernel<<<(R + kWarps - 1) / kWarps, kThreads, 0, stream>>>(pair, row_mask, row_slot, R,
                                                                      W, P, outer, row_cnt);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  plan_kernel<<<1, kRankThreads, 0, stream>>>(row_mask, row_slot, R, P, cap, row_cnt, row_off,
                                              rank, rowlist, slot_start, prefix, n_slot, n_start,
                                              pos_base, oidx, counters, info, overflow);
  return (int)cudaGetLastError();
}

// The output rows' probe row, view element, slot and first row, and valid.
int pj_fill(const bool* pair, const bool* row_mask, const int32_t* row_slot, int R, int W, int P,
            int outer, int cap, int rows, const int32_t* row_off, const int32_t* n_start,
            const int32_t* oidx, const int32_t* info, int32_t* pi, int32_t* pidx,
            int32_t* out_slot, int32_t* out_first, bool* valid, cudaStream_t stream) {
  const int need = (R > rows / 32 ? R : rows / 32) + 1;
  int blocks = (need + kWarps - 1) / kWarps;
  blocks = blocks > 65535 ? 65535 : blocks;
  fill_kernel<<<blocks, kThreads, 0, stream>>>(pair, row_mask, row_slot, R, W, P, outer, cap,
                                               rows, row_off, n_start, oidx, info, pi, pidx,
                                               out_slot, out_first, valid);
  return (int)cudaGetLastError();
}

}  // extern "C"
