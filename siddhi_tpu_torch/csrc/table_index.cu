// K22: a table column's sorted index and the indexed update's probe, for
// Hopper (sm_90a).
//
// Replaces siddhi_tpu/core/table.py InMemoryTable._rebuild_index (:337-351)
// and the probe of _update_indexed (:606-674).
//
// Build: every slot becomes a record (empty flag, sortable key, slot): a
// float key maps to an unsigned integer in the sort's total order (-0.0 and
// 0.0 one value, every NaN one value after +inf, as the JAX sort
// canonicalises them), an int to its offset binary. A bitonic sort over the
// records padded to a power of two N >= 1024 orders them — whole 1024-record
// blocks in shared memory (the first ten merge levels in one launch, then the
// last ten steps of each later level), the longer steps one launch each — and
// since the slot is part of the record, equal keys keep slot order: the
// stable lexsort of (empty, key). Then ix_order, the keys in that order (the
// column's largest value for an empty slot) and the adjacent-duplicate flag.
//
// Probe: per probe row, a binary search of its probe (cast to the key dtype
// by the caller) for the first sorted key not below it; the candidate slot
// hits when it is valid and its key equals the raw probe under numeric
// promotion (the caller's cast of the probe to the promoted dtype); an
// atomicMax per slot keeps the last hitting row, the slot's writer. A probe
// the caller marks not ok (an invalid row, a null probe) writes nothing.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "prog.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSortBlock = 1024;

// records: rec (the sortable key), tag (bit 31 the empty flag, then the slot)
__device__ __forceinline__ bool rec_less(unsigned long long ra, unsigned int ta,
                                         unsigned long long rb, unsigned int tb) {
  const unsigned int fa = ta >> 31, fb = tb >> 31;
  if (fa != fb) return fa < fb;
  if (ra != rb) return ra < rb;
  return (ta & 0x7fffffffu) < (tb & 0x7fffffffu);
}

__global__ void prep_kernel(const void* keys, int ty, const bool* valid, int C, int N,
                            unsigned long long* rec, unsigned int* tag) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  if (i < C) {
    rec[i] = total_key(load_elem(keys, i, ty), ty);
    tag[i] = (valid[i] ? 0u : 0x80000000u) | (unsigned int)i;
  } else {
    rec[i] = ~0ULL;
    tag[i] = 0xffffffffu;
  }
}

// one step (k, j) of the network over global memory
__global__ void step_kernel(unsigned long long* rec, unsigned int* tag, int N, int j, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int p = i ^ j;
  if (p <= i) return;
  const bool up = (i & k) == 0;
  const unsigned long long ri = rec[i], rp = rec[p];
  const unsigned int ti = tag[i], tp = tag[p];
  if (up ? rec_less(rp, tp, ri, ti) : rec_less(ri, ti, rp, tp)) {
    rec[i] = rp;
    rec[p] = ri;
    tag[i] = tp;
    tag[p] = ti;
  }
}

// in shared memory, one 1024-record block: k_only == 0 runs every level
// k = 2..1024 with all its steps; otherwise the steps j = 512..1 of level k
__global__ void block_kernel(unsigned long long* rec, unsigned int* tag, int k_only) {
  __shared__ unsigned long long s_rec[kSortBlock];
  __shared__ unsigned int s_tag[kSortBlock];
  const int t = threadIdx.x;
  const int base = blockIdx.x * kSortBlock;
  s_rec[t] = rec[base + t];
  s_tag[t] = tag[base + t];
  __syncthreads();
  const int k_lo = k_only ? k_only : 2, k_hi = k_only ? k_only : kSortBlock;
  for (int k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = (k_only ? kSortBlock : k) >> 1; j > 0; j >>= 1) {
      const int p = t ^ j;
      if (p > t) {
        const bool up = ((base + t) & k) == 0;
        const unsigned long long ri = s_rec[t], rp = s_rec[p];
        const unsigned int ti = s_tag[t], tp = s_tag[p];
        if (up ? rec_less(rp, tp, ri, ti) : rec_less(ri, ti, rp, tp)) {
          s_rec[t] = rp;
          s_rec[p] = ri;
          s_tag[t] = tp;
          s_tag[p] = ti;
        }
      }
      __syncthreads();
    }
  }
  rec[base + t] = s_rec[t];
  tag[base + t] = s_tag[t];
}

__global__ void finish_kernel(const void* keys, int ty, const unsigned int* tag, int C,
                              int32_t* order, void* sk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C) return;
  const unsigned int t = tag[i];
  const int slot = (int)(t & 0x7fffffffu);
  order[i] = slot;
  Val v;
  if (t >> 31) {  // an empty slot: the column's largest value
    switch (ty) {
      case TY_FLOAT: v.f = __int_as_float(0x7f800000); break;
      case TY_LONG: v.i = 0x7fffffffffffffffLL; break;
      case TY_BOOL: v.i = 1; break;
      default: v.i = 0x7fffffff; break;
    }
  } else {
    v = load_elem(keys, slot, ty);
  }
  store_elem(sk, i, ty, v);
}

__global__ void dups_kernel(const void* sk, int ty, const unsigned int* tag, int C, bool* dups) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x + 1;
  if (i >= C) return;
  if ((tag[i] >> 31) || (tag[i - 1] >> 31)) return;
  if (raw_eq(load_elem(sk, i, ty), load_elem(sk, i - 1, ty), ty)) *dups = true;
}

__global__ void probe_kernel(const void* keys, int kty, const bool* valid, const int32_t* order,
                             const void* sk, int C, const void* probe, const void* probe_cmp,
                             int pty, const bool* ok, int B, int32_t* cand_hit,
                             int32_t* winner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  int h = -1;
  if (ok[i] && C > 0) {
    const unsigned long long x = total_key(load_elem(probe, i, kty), kty);
    int lo = 0, hi = C;
    while (lo < hi) {
      const int mid = (int)(((unsigned int)lo + (unsigned int)hi) >> 1);
      if (total_key(load_elem(sk, mid, kty), kty) < x) lo = mid + 1;
      else hi = mid;
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

__global__ void target_kernel(const int32_t* winner, int B, int C, int32_t* target) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int h = target[i];  // cand_hit, overwritten in place
  target[i] = h >= 0 && winner[h] == i ? h : C;
}

int grid(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// The sorted index of keys [C] (type ty) over valid [C]: order int32 [C],
// sk [C] (keys' dtype), dups (0-d bool). rec/tag: scratch of N records,
// N the power of two >= C (at least 1024 is used when C < 1024: rec and tag
// must then hold 1024).
int ti_build(const void* keys, int ty, const bool* valid, int C, int N, unsigned long long* rec,
             unsigned int* tag, int32_t* order, void* sk, bool* dups, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(dups, 0, 1, stream);
  if (err != cudaSuccess) return (int)err;
  if (C <= 0) return 0;
  if (N < kSortBlock) N = kSortBlock;
  prep_kernel<<<grid(N), kThreads, 0, stream>>>(keys, ty, valid, C, N, rec, tag);
  block_kernel<<<N / kSortBlock, kSortBlock, 0, stream>>>(rec, tag, 0);
  for (int k = 2 * kSortBlock; k <= N; k <<= 1) {
    for (int j = k >> 1; j >= kSortBlock; j >>= 1)
      step_kernel<<<grid(N), kThreads, 0, stream>>>(rec, tag, N, j, k);
    block_kernel<<<N / kSortBlock, kSortBlock, 0, stream>>>(rec, tag, k);
  }
  finish_kernel<<<grid(C), kThreads, 0, stream>>>(keys, ty, tag, C, order, sk);
  if (C > 1) dups_kernel<<<grid(C - 1), kThreads, 0, stream>>>(sk, ty, tag, C, dups);
  return (int)cudaGetLastError();
}

// The indexed probe: target int32 [B], the slot row i writes or C.
// probe [B] in the key dtype (kty), probe_cmp [B] in the promoted dtype
// (pty), ok [B]. winner: int32 scratch [C].
int ti_probe(const void* keys, int kty, const bool* valid, const int32_t* order, const void* sk,
             int C, const void* probe, const void* probe_cmp, int pty, const bool* ok, int B,
             int32_t* winner, int32_t* target, cudaStream_t stream) {
  if (B <= 0) return 0;
  cudaError_t err = cudaMemsetAsync(winner, 0xff, (size_t)(C > 0 ? C : 1) * sizeof(int32_t),
                                    stream);
  if (err != cudaSuccess) return (int)err;
  probe_kernel<<<grid(B), kThreads, 0, stream>>>(keys, kty, valid, order, sk, C, probe,
                                                 probe_cmp, pty, ok, B, target, winner);
  target_kernel<<<grid(B), kThreads, 0, stream>>>(winner, B, C, target);
  return (int)cudaGetLastError();
}

}  // extern "C"
