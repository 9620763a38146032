// Ring view: a sliding window's ring slots in insertion order, for Hopper
// (sm_90a).
//
// Replaces siddhi_tpu/core/windows.py SlidingWindow._view_perm + view
// (:438-452): a stable argsort of the slots' seq (empty slots, seq -1,
// last in slot order), then every column, the ts lane and the mask
// gathered in that order, for a join to probe. No sort is needed: a live
// seq lies in [total - W, total), so seq - (total - W) is a dense index in
// [0, W). One block scatters each live slot into that index (slot_at, in
// shared memory up to kSharedSlots slots, else in a global scratch), and
// one block scan over the index gives each live slot its view row; a second
// scan ranks the empty slots after them. The thread that places a slot
// copies its elements of every lane (up to kMaxViewLanes a launch, passed
// by value) and the mask, so a view is one launch. A length ring without
// holes comes out as a rotation by total mod W; a time ring with holes
// comes out compacted. What bounds it on the card: bytes, W slots read and
// written per lane (tens of KB at W = 1024); at that size the launch and
// the wrapper's host work dominate, which is what one launch a view cuts.
//
// K48, the seq view: replaces siddhi_tpu/core/windows.py
// SlidingWindow.view_seq (:453), the ring's admission seqs in view order,
// which join lineage pairs with the view's lanes by position. The same
// launch writes it as one more lane, the seq at each view row, so the seq
// lane and the view can never disagree: a live row's seq is total - W + i
// by construction, an empty row's is the slot's own (negative) seq. Bound:
// bytes, W int64 seqs read and written (16 KB at W = 1024); the launch
// dominates.
//
// rv_gather_N: out[k] = src[perm[k]], the gather that K12's probe lanes
// and K46's kept rows take.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;
constexpr int kMaxViewLanes = 32;
// slot_at's slots in dynamic shared memory (4 bytes each, 224 KB of the
// block's 227 KB); a larger ring takes a [W] int32 global scratch
constexpr int kSharedSlots = 56 * 1024;

struct ViewLanes {
  const void* src[kMaxViewLanes];  // [W] ring lane
  void* dst[kMaxViewLanes];        // [W] view lane
  int size[kMaxViewLanes];         // element bytes: 1, 2, 4 or 8
  int n;
};

template <typename E>
__device__ __forceinline__ void copy_elem(const ViewLanes& L, int k, int p, int j) {
  static_cast<E*>(L.dst[k])[p] = static_cast<const E*>(L.src[k])[j];
}

// view row p shows slot j: every lane's element
__device__ __forceinline__ void copy_row(const ViewLanes& L, int p, int j) {
  for (int k = 0; k < L.n; ++k) {
    switch (L.size[k]) {
      case 1: copy_elem<uint8_t>(L, k, p, j); break;
      case 2: copy_elem<uint16_t>(L, k, p, j); break;
      case 4: copy_elem<uint32_t>(L, k, p, j); break;
      default: copy_elem<unsigned long long>(L, k, p, j); break;
    }
  }
}

// View row p shows slot perm(p); mask[p] = p < live slots and vseq[p] =
// seq[perm(p)] (each when not null); L's lanes gathered by perm. slot_at_g:
// a [W] int32 scratch, or null for shared memory (W <= kSharedSlots).
__global__ void __launch_bounds__(kBlock, 1)
view_kernel(const int64_t* seq, const int64_t* total, int W, int32_t* slot_at_g, ViewLanes L,
            bool* mask, int64_t* vseq) {
  extern __shared__ int32_t slot_sh[];
  __shared__ int ws[32];
  __shared__ int tile_total;
  int32_t* slot_at = slot_at_g != nullptr ? slot_at_g : slot_sh;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long base_seq = *total - W;
  for (int i = tid; i < W; i += nt) slot_at[i] = -1;
  __syncthreads();
  for (int j = tid; j < W; j += nt) {
    const long long s = seq[j];
    const long long i = s - base_seq;
    if (s >= 0 && i >= 0 && i < W) slot_at[i] = j;
  }
  __syncthreads();
  int live = 0;
  for (int base = 0; base < W; base += nt) {
    const int i = base + tid;
    const int j = i < W ? slot_at[i] : -1;
    const int excl = block_excl_sum(j >= 0, ws, &tile_total);
    if (j >= 0) {
      copy_row(L, live + excl, j);
      if (vseq != nullptr) vseq[live + excl] = base_seq + i;
    }
    live += tile_total;
  }
  int empty = 0;
  for (int base = 0; base < W; base += nt) {
    const int j = base + tid;
    const bool hole = j < W && seq[j] < 0;
    const int excl = block_excl_sum(hole, ws, &tile_total);
    if (hole) {
      copy_row(L, live + empty + excl, j);
      if (vseq != nullptr) vseq[live + empty + excl] = seq[j];
    }
    empty += tile_total;
  }
  if (mask != nullptr)
    for (int p = tid; p < W; p += nt) mask[p] = p < live;
}

}  // namespace

extern "C" {

// The view of one ring: n lanes (src[k] -> dst[k], size[k] bytes an
// element), the mask and, when vseq is not null, K48's seq lane. One launch
// up to kMaxViewLanes lanes (a wider ring takes one more a kMaxViewLanes,
// each recomputing the order). slot_at: a [W] int32 scratch when W >
// kSharedSlots, else null.
int rv_view(const int64_t* seq, const int64_t* total, int W, int32_t* slot_at, int n,
            const void* const* src, void* const* dst, const int* size, bool* mask, int64_t* vseq,
            cudaStream_t stream) {
  if (W < 1 || (W > kSharedSlots && slot_at == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t shared = slot_at == nullptr ? (size_t)W * sizeof(int32_t) : 0;
  if (shared > 48 * 1024) {  // the opt-in above 48 KB
    const cudaError_t e = cudaFuncSetAttribute(
        view_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedSlots * 4);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = W >= kBlock ? kBlock : ((W + 31) / 32) * 32;
  int base = 0;
  do {
    ViewLanes L;
    L.n = n - base < kMaxViewLanes ? n - base : kMaxViewLanes;
    for (int k = 0; k < L.n; ++k) {
      L.src[k] = src[base + k];
      L.dst[k] = dst[base + k];
      L.size[k] = size[base + k];
    }
    view_kernel<<<1, threads, shared, stream>>>(seq, total, W, slot_at, L,
                                                base == 0 ? mask : nullptr,
                                                base == 0 ? vseq : nullptr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    base += kMaxViewLanes;
  } while (base < n);
  return 0;
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
