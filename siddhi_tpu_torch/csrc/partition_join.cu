// K38-K39: a join step inside a partition, for Hopper (sm_90a).
//
// Replaces siddhi_tpu/core/partition.py PartitionedJoinQueryRuntime
// `_pstep_impl` (:214), which runs the join step (core/join.py:255-430
// `CompiledJoin.step` / `_assemble`) under `jax.vmap` over P partitions, and
// `_flatten` (:436), which orders the vmapped [P, cap] output by position
// first and slot second:
//   - K38 `pj_view`: each partition's ring in insertion order (core/
//     windows.py:438-452 `_view_perm` / `view` under the vmap), K11's
//     design (ring_view.cu) over P slots: a live seq lies in [total[q] - W,
//     total[q]), so seq - (total[q] - W) is a dense index into the slot's
//     [W] `slot_at` row, in shared memory (a global [P * W] scratch only
//     past it). A group of G threads (a power of two from 32 to 1,024, the
//     least at or past W) a slot, several slots a block while G < 256: one
//     group scan compacts the live slots, a second ranks the empty ones
//     after them, and the thread that places a slot copies its element of
//     every lane (up to kViewLanes a launch, passed by value) and writes
//     the mask: a view is one launch. Bound: bytes, the ring read and the
//     view written once (a few MB at P = 1,024, W = 50); the launch and the
//     wrapper dominate at that size.
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
// block that ranks and places the rows serialises ~R/1024 block scans.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "partition.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kViewBlock = 256;  // threads a block of K38 while a group is smaller
constexpr int kViewLanes = 32;   // lanes a launch of K38, by value
// slot_at's slots a block in dynamic shared memory (4 bytes each, 224 KB of
// the block's 227 KB); past it a [P * W] int32 global scratch
constexpr int kViewSharedSlots = 56 * 1024;

struct ViewLanes {
  const void* src[kViewLanes];  // [P, W] ring lane
  void* dst[kViewLanes];        // [P, W] view lane
  int size[kViewLanes];         // element bytes: 1, 2, 4 or 8
  int n;
};

template <typename E>
__device__ __forceinline__ void view_elem(const ViewLanes& L, int k, size_t p, size_t j) {
  static_cast<E*>(L.dst[k])[p] = static_cast<const E*>(L.src[k])[j];
}

// view element p shows ring element j: every lane's element
__device__ __forceinline__ void view_row(const ViewLanes& L, size_t p, size_t j) {
  for (int k = 0; k < L.n; ++k) {
    switch (L.size[k]) {
      case 1: view_elem<uint8_t>(L, k, p, j); break;
      case 2: view_elem<uint16_t>(L, k, p, j); break;
      case 4: view_elem<uint32_t>(L, k, p, j); break;
      default: view_elem<unsigned long long>(L, k, p, j); break;
    }
  }
}

// Exclusive sum of v over the group of G threads (G a multiple of 32 that
// divides blockDim.x) holding this thread; *total gets the group's sum.
// Every thread of the block calls it; ws: a __shared__ int[32].
__device__ __forceinline__ int group_excl_sum(int v, int G, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  int before = 0, tot = 0;
  if (G == 32) {
    tot = __shfl_sync(kFull, incl, 31);
  } else {
    if (lane == 31) ws[warp] = incl;
    __syncthreads();
    const int w0 = warp & ~(G / 32 - 1);  // the group's first warp
    for (int w = w0; w < w0 + G / 32; ++w) {
      const int x = ws[w];
      before += w < warp ? x : 0;
      tot += x;
    }
    __syncthreads();
  }
  *total = tot;
  return incl - v + before;
}

// View element q*W + p shows slot q's ring element perm(p); mask[q*W + p] =
// p < slot q's live elements; L's lanes placed by the placing thread.
// slot_at_g: a [P * W] int32 scratch, or null for shared memory.
__global__ void __launch_bounds__(1024)
view_kernel(const int64_t* seq, const int64_t* total, int P, int W, int G,
            int32_t* slot_at_g, const __grid_constant__ ViewLanes L, bool* mask) {
  extern __shared__ int32_t slot_sh[];
  __shared__ int ws[32];
  const int g = threadIdx.x / G, t = threadIdx.x % G;
  const int q = blockIdx.x * (blockDim.x / G) + g;
  const bool on = q < P;  // a group past the last slot still joins the scans
  const size_t row = (size_t)(on ? q : 0) * W;
  int32_t* sa = slot_at_g != nullptr ? slot_at_g + row : slot_sh + (size_t)g * W;
  const int64_t* sq = seq + row;
  const long long base_seq = on ? total[q] - W : 0;
  if (on)
    for (int i = t; i < W; i += G) sa[i] = -1;
  __syncthreads();
  if (on)
    for (int j = t; j < W; j += G) {
      const long long s = sq[j];
      const long long i = s - base_seq;
      if (s >= 0 && i >= 0 && i < W) sa[i] = j;
    }
  __syncthreads();
  int live = 0, tot;
  for (int base = 0; base < W; base += G) {
    const int i = base + t;
    const int j = on && i < W ? sa[i] : -1;
    const int excl = group_excl_sum(j >= 0, G, ws, &tot);
    if (j >= 0) view_row(L, row + live + excl, row + j);
    live += tot;
  }
  int empty = 0;
  for (int base = 0; base < W; base += G) {
    const int j = base + t;
    const bool hole = on && j < W && sq[j] < 0;
    const int excl = group_excl_sum(hole, G, ws, &tot);
    if (hole) view_row(L, row + live + empty + excl, row + j);
    empty += tot;
  }
  if (on && mask != nullptr)
    for (int p = t; p < W; p += G) mask[row + p] = p < live;
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

// The keyed view of P rings: n lanes and the [P, W] mask; args holds n
// source pointers, n destination pointers, then n element sizes (lane k
// from args[k] to args[n + k], [P, W] each, args[2n + k] bytes an
// element). One launch up to
// kViewLanes lanes (more take one more launch a kViewLanes, each ranking
// again). slot_at: a [P * W] int32 scratch when a block's slots pass
// kViewSharedSlots (ops/partition.py `_pj_view_scratch` says), else null.
int pj_view(const int64_t* seq, const int64_t* total, int P, int W, int32_t* slot_at, int n,
            const long long* args, bool* mask, cudaStream_t stream) {
  if (P < 1 || W < 1 || n < 0) return (int)cudaErrorInvalidValue;
  int G = 32;
  while (G < W && G < 1024) G <<= 1;
  const int threads = G < kViewBlock ? kViewBlock : G;
  const int per_block = threads / G;
  const size_t shared = (size_t)per_block * W * sizeof(int32_t);
  if (slot_at == nullptr) {
    if (shared > (size_t)kViewSharedSlots * sizeof(int32_t)) return (int)cudaErrorInvalidValue;
    if (shared > 48 * 1024) {  // the opt-in above 48 KB
      const cudaError_t e = cudaFuncSetAttribute(
          view_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kViewSharedSlots * (int)sizeof(int32_t));
      if (e != cudaSuccess) return (int)e;
    }
  }
  const int blocks = (P + per_block - 1) / per_block;
  int base = 0;
  do {
    ViewLanes L;
    L.n = n - base < kViewLanes ? n - base : kViewLanes;
    for (int k = 0; k < L.n; ++k) {
      L.src[k] = (const void*)args[base + k];
      L.dst[k] = (void*)args[n + base + k];
      L.size[k] = (int)args[2 * n + base + k];
    }
    view_kernel<<<blocks, threads, slot_at == nullptr ? shared : 0, stream>>>(
        seq, total, P, W, G, slot_at, L, base == 0 ? mask : nullptr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    base += kViewLanes;
  } while (base < n);
  return 0;
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
