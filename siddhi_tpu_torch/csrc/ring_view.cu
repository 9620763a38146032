// Ring view: a sliding window's ring slots in insertion order, for Hopper
// (sm_90a).
//
// Replaces siddhi_tpu/core/windows.py SlidingWindow._view_perm + view
// (:438-452): a stable argsort of the slots' seq (empty slots, seq -1,
// last in slot order), then every column, the ts lane and the mask
// gathered in that order, for a join to probe. No sort is needed: a live
// seq lies in [total - W, total), so seq - (total - W) is a dense index in
// [0, W). One block scatters each live slot into that index, and one scan
// over the index gives each live slot its rank; a second scan ranks the
// empty slots after them. A length ring without holes comes out as a
// rotation by total mod W; a time ring with holes comes out compacted.
// What bounds it on the card: bytes, W slots read and written per lane
// (tens of KB at W = 1024); at that size the launch and the one scan block
// dominate.
//
// K48, the seq view (rv_order_seq): replaces siddhi_tpu/core/windows.py
// SlidingWindow.view_seq (:453), the ring's admission seqs in view order,
// which join lineage pairs with the view's lanes by position. It is the
// same order pass writing one more lane, the seq at each view row, from
// the same launch, so the seq lane and the perm that gathers the view can
// never disagree: a live row's seq is total - W + i by construction, an
// empty row's is the slot's own (negative) seq. Bound: bytes, W int64 seqs
// read and written (16 KB at W = 1024); the launch dominates.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;

// perm[p] = the slot shown at view row p; mask[p] = p < live slots;
// vseq[p] (when not null) = seq[perm[p]].
// slot_at[i] (scratch, [W]) = the live slot whose seq is total - W + i.
__global__ void __launch_bounds__(kBlock, 1)
order_kernel(const int64_t* seq, const int64_t* total, int W, int32_t* slot_at,
             int32_t* perm, bool* mask, int64_t* vseq) {
  __shared__ int ws[32];
  __shared__ int tile_total;
  const int tid = threadIdx.x;
  const long long base_seq = *total - W;
  for (int i = tid; i < W; i += kBlock) slot_at[i] = -1;
  __syncthreads();
  for (int j = tid; j < W; j += kBlock) {
    const long long s = seq[j];
    const long long i = s - base_seq;
    if (s >= 0 && i >= 0 && i < W) slot_at[i] = j;
  }
  __syncthreads();
  int live = 0;
  for (int base = 0; base < W; base += kBlock) {
    const int i = base + tid;
    const int j = i < W ? slot_at[i] : -1;
    const int excl = block_excl_sum(j >= 0, ws, &tile_total);
    if (j >= 0) {
      perm[live + excl] = j;
      if (vseq != nullptr) vseq[live + excl] = base_seq + i;
    }
    live += tile_total;
  }
  int empty = 0;
  for (int base = 0; base < W; base += kBlock) {
    const int j = base + tid;
    const bool hole = j < W && seq[j] < 0;
    const int excl = block_excl_sum(hole, ws, &tile_total);
    if (hole) {
      perm[live + empty + excl] = j;
      if (vseq != nullptr) vseq[live + empty + excl] = seq[j];
    }
    empty += tile_total;
  }
  for (int p = tid; p < W; p += kBlock) mask[p] = p < live;
}

}  // namespace

extern "C" {

int rv_order(const int64_t* seq, const int64_t* total, int W, int32_t* slot_at,
             int32_t* perm, bool* mask, cudaStream_t stream) {
  order_kernel<<<1, kBlock, 0, stream>>>(seq, total, W, slot_at, perm, mask, nullptr);
  return (int)cudaGetLastError();
}

// K48: the order pass with the seq lane in view order (vseq, [W] int64)
int rv_order_seq(const int64_t* seq, const int64_t* total, int W, int32_t* slot_at,
                 int32_t* perm, bool* mask, int64_t* vseq, cudaStream_t stream) {
  order_kernel<<<1, kBlock, 0, stream>>>(seq, total, W, slot_at, perm, mask, vseq);
  return (int)cudaGetLastError();
}

// out[k] = src[perm[k]] (a non-negative index, any size)
int rv_gather_1(const void* src, const int32_t* perm, void* out, int n, cudaStream_t stream) {
  return gather2<uint8_t>(src, nullptr, perm, 0, out, n, INT_MAX, stream);
}
int rv_gather_4(const void* src, const int32_t* perm, void* out, int n, cudaStream_t stream) {
  return gather2<uint32_t>(src, nullptr, perm, 0, out, n, INT_MAX, stream);
}
int rv_gather_8(const void* src, const int32_t* perm, void* out, int n, cudaStream_t stream) {
  return gather2<unsigned long long>(src, nullptr, perm, 0, out, n, INT_MAX, stream);
}

}  // extern "C"
