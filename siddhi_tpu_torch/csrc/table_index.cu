// K22: a table column's sorted index and the indexed update's probe, for
// Hopper (sm_90a).
//
// Replaces siddhi_tpu/core/table.py InMemoryTable._rebuild_index (:337-351)
// and the probe of _update_indexed (:606-674).
//
// Build: every slot becomes two words, its empty flag and its key in the
// sort's total order (a float key mapped to an unsigned integer: -0.0 and
// 0.0 one value, every NaN one value after +inf, as the JAX sort
// canonicalises them; an int its offset binary), with the slot as payload.
// `radix_sort.cuh` sorts them stably — one block in shared memory up to one
// tile (2,048 slots), else one cooperative launch over the grid — which is
// the stable lexsort of (empty, key): equal keys keep slot order. The last
// pass writes ix_order and the keys in that order (the column's largest
// value for an empty slot); one pass over the sorted slots then sets the
// adjacent-duplicate flag.
//
// Probe: per probe row, a binary search of its probe (cast to the key dtype
// by the caller) for the first sorted key not below it, its first ten
// levels read from a copy of the search tree's top in shared memory; the
// candidate slot hits when it is valid and its key equals the raw probe
// under numeric promotion (the caller's cast of the probe to the promoted
// dtype); an atomicMax per slot keeps the last hitting row, the slot's
// writer. A probe the caller marks not ok (an invalid row, a null probe)
// writes nothing. The per-slot scratch is -1 between calls: the writer
// resets its slot when it reads itself there, so no call clears it.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "prog.cuh"
#include "radix_sort.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTreeNodes = 1024;  // the search tree's top ten levels, heap order

// Slot r's words: its empty flag, then its key in the total order.
struct IndexWords {
  const void* keys;
  int ty;
  const bool* valid;
  __device__ unsigned long long operator()(int w, int r) const {
    return w == 0 ? (valid[r] ? 0ull : 1ull) : total_key(load_elem(keys, r, ty), ty);
  }
};

// The index's lanes: ix_order, the sorted keys (the column's largest value
// for an empty slot) and the duplicate flag.
struct IndexOut {
  const void* keys;
  int ty;
  const bool* valid;
  int32_t* order;
  void* sk;
  bool* dups;
  __device__ void put(int i, int slot) const {
    order[i] = slot;
    Val v;
    if (valid[slot]) {
      v = load_elem(keys, slot, ty);
    } else {
      switch (ty) {
        case TY_FLOAT: v.f = __int_as_float(0x7f800000); break;
        case TY_LONG: v.i = 0x7fffffffffffffffLL; break;
        case TY_BOOL: v.i = 1; break;
        default: v.i = 0x7fffffff; break;
      }
    }
    store_elem(sk, i, ty, v);
  }
  // sorted places i - 1 and i (i >= 1) hold two valid slots of equal keys
  __device__ bool dup_at(int i) const {
    return valid[order[i]] && valid[order[i - 1]] && same_at(i);
  }
  __device__ bool same_at(int i) const {
    return raw_eq(load_elem(sk, i, ty), load_elem(sk, i - 1, ty), ty);
  }
};

union TileIndexSmem {
  TileSmem<kBlockSortThreads, kBlockSortIPT> t;
  unsigned long long red[2][kMaxSortWords][32];
};

// Up to one tile of slots: the sort and the index in one block.
__global__ void __launch_bounds__(kBlockSortThreads)
ti_tile_kernel(int C, IndexWords words, IndexOut out) {
  __shared__ TileIndexSmem u;
  __shared__ PassList pl;
  radix_sort_block<kBlockSortThreads, kBlockSortIPT>(C, 2, words, u.t, u.red, pl);
  const int tid = threadIdx.x;
  for (int i = tid; i < C; i += kBlockSortThreads) out.put(i, u.t.val[i]);
  __syncthreads();
  bool dup = false;
  for (int i = tid + 1; i < C; i += kBlockSortThreads) dup |= out.dup_at(i);
  dup = __syncthreads_or(dup) != 0;
  if (tid == 0) *out.dups = dup;
}

// Above one tile: the sort over the grid (cooperative launch), its last
// pass writing the index, then the duplicate flag.
__global__ void __launch_bounds__(kSortThreads)
ti_grid_kernel(int C, IndexWords words, IndexOut out, RadixWork wk) {
  __shared__ GridSmem s;
  if (blockIdx.x == 0 && threadIdx.x == 0) *out.dups = false;
  radix_sort_grid(C, 2, words, wk, s, [&](int i, int slot) { out.put(i, slot); });
  cg::this_grid().sync();
  // the valid slots come first: C less the slots whose empty flag is 1
  const int nv = C - radix_count(wk, s, C, 0, 0, 1);
  bool dup = false;
  for (int i = blockIdx.x * kSortThreads + threadIdx.x + 1; i < nv; i += gridDim.x * kSortThreads)
    dup |= out.same_at(i);
  if (__syncthreads_or(dup) && threadIdx.x == 0) *out.dups = true;
}

__global__ void probe_kernel(const void* keys, int kty, const bool* valid, const int32_t* order,
                             const void* sk, int C, const void* probe, const void* probe_cmp,
                             int pty, const bool* ok, int B, int32_t* cand_hit,
                             int32_t* winner) {
  // node n of the search tree (n >= 1; children 2n, 2n + 1): the total key
  // at the middle of the interval the search reaches n with
  __shared__ unsigned long long tree[kTreeNodes];
  for (int n = threadIdx.x; n < kTreeNodes; n += blockDim.x) {
    unsigned long long v = 0ull;
    if (n > 0) {
      int lo = 0, hi = C;
      for (int l = 30 - __clz(n); l >= 0; --l) {  // the path's turns below the root
        const int mid = (int)(((unsigned int)lo + (unsigned int)hi) >> 1);
        if ((n >> l) & 1) lo = mid + 1;
        else hi = mid;
      }
      if (lo < hi)
        v = total_key(load_elem(sk, (int)(((unsigned int)lo + (unsigned int)hi) >> 1), kty), kty);
    }
    tree[n] = v;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int h = -1;
  if (ok[i] && C > 0) {
    const unsigned long long x = total_key(load_elem(probe, i, kty), kty);
    int lo = 0, hi = C, n = 1;
    while (lo < hi) {
      const int mid = (int)(((unsigned int)lo + (unsigned int)hi) >> 1);
      const bool right =
          (n < kTreeNodes ? tree[n] : total_key(load_elem(sk, mid, kty), kty)) < x;
      if (right) lo = mid + 1;
      else hi = mid;
      if (n < kTreeNodes) n = 2 * n + (right ? 1 : 0);
    }
    const int pos = lo < C ? lo : C - 1;
    const int cand = order[pos];
    if (valid[cand] &&
        raw_eq(convert(load_elem(keys, cand, kty), kty, pty), load_elem(probe_cmp, i, pty), pty)) {
      h = cand;
      atomicMax(&winner[cand], i);
    }
  }
  cand_hit[i] = h;
}

// A row writes its candidate when it is the slot's last hitting row; that
// row puts the slot's scratch back to -1. Another row of the slot reads its
// writer or -1 there, never itself.
__global__ void target_kernel(int32_t* winner, int B, int C, int32_t* target) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int h = target[i];  // cand_hit, overwritten in place
  const bool win = h >= 0 && winner[h] == i;
  target[i] = win ? h : C;
  if (win) winner[h] = -1;
}

int grid(long long n) { return (int)((n + kThreads - 1) / kThreads); }

size_t ti_carve(char* base, int C, RadixWork* rw) {
  Carve c{base, 0};
  if (C > kSortTile) *rw = carve_radix(c, C, 2);
  return c.off + 256;
}

}  // namespace

extern "C" {

// The bytes of ti_build's workspace for C slots.
long long ti_build_workspace(int C) {
  RadixWork rw;
  return (long long)ti_carve(nullptr, C < 0 ? 0 : C, &rw);
}

// The sorted index of keys [C] (type ty) over valid [C]: order int32 [C],
// sk [C] (keys' dtype), dups (0-d bool). work: ti_build_workspace(C) bytes.
int ti_build(const void* keys, int ty, const bool* valid, int C, int32_t* order, void* sk,
             bool* dups, void* work, cudaStream_t stream) {
  if (C <= 0) return (int)cudaMemsetAsync(dups, 0, 1, stream);
  IndexWords words{keys, ty, valid};
  IndexOut out{keys, ty, valid, order, sk, dups};
  if (C <= kSortTile) {
    ti_tile_kernel<<<1, kBlockSortThreads, 0, stream>>>(C, words, out);
    return (int)cudaGetLastError();
  }
  RadixWork rw{};
  ti_carve((char*)work, C, &rw);
  int blocks = 0;
  cudaError_t err = coop_blocks(ti_grid_kernel, C, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&C, &words, &out, &rw};
  return (int)cudaLaunchCooperativeKernel((const void*)ti_grid_kernel, dim3(blocks),
                                          dim3(kSortThreads), args, 0, stream);
}

// The indexed probe: target int32 [B], the slot row i writes or C.
// probe [B] in the key dtype (kty), probe_cmp [B] in the promoted dtype
// (pty), ok [B]. winner: int32 scratch [C], all -1 on entry and on return.
int ti_probe(const void* keys, int kty, const bool* valid, const int32_t* order, const void* sk,
             int C, const void* probe, const void* probe_cmp, int pty, const bool* ok, int B,
             int32_t* winner, int32_t* target, cudaStream_t stream) {
  if (B <= 0) return 0;
  probe_kernel<<<grid(B), kThreads, 0, stream>>>(keys, kty, valid, order, sk, C, probe,
                                                 probe_cmp, pty, ok, B, target, winner);
  target_kernel<<<grid(B), kThreads, 0, stream>>>(winner, B, C, target);
  return (int)cudaGetLastError();
}

}  // extern "C"
