// Device routines the keyed partition kernels share (csrc/partition_window.cu
// K29, partition_time.cu K31, partition_batch.cu K32, group_assign.cu K33):
// stable counting ranks in one block, each slot's member rows, and the
// (position, slot) placement of every slot's output rows (the row lists of
// K31, K32 and K37 are csrc/partition_rows.cuh's).
//
// The JAX package flattens a vmapped [P, K] output by output position first
// and partition slot second (siddhi_tpu/core/partition.py `_flatten`). With
// n_p rows out of slot p, row (pos, p) lands at
//   A(pos) + #{q < p : n_q > pos},   A(pos) = sum_q min(n_q, pos).
// Both counts are stable counting ranks: A(pos) from a histogram of n_p, the
// second term the rank of item (pos, p) among the items of its position,
// the items listed slot by slot. Each 1024-item tile ranks within a warp by
// __match_any_sync, then warp 0 walks the tile's 32 warps in order adding
// each run's size to the key's counter (in shared memory up to
// kSmemCounters keys, else in a global scratch): a counting pass, no sort.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kRankThreads = 1024;
constexpr int kSmemCounters = 8192;

struct RankSmem {
  int key[kRankThreads];
  int size[kRankThreads];
  int base[kRankThreads];
  int ws[32];
  int cnt[kSmemCounters];
  int maxn, live;
};

// The slot whose items [n_start[p], n_start[p + 1]) hold item t.
__device__ __forceinline__ int slot_of_item(const int32_t* n_start, int P, int t) {
  int lo = 0, hi = P - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (n_start[mid] <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Stable counting ranks of items 0..n-1 by key_of(i) (a key < 0 takes no
// rank): out(i, key, rank) gets the count of earlier items with the same
// key plus the key's counter on entry; the counters advance by the counts.
// Every thread of the block calls it.
template <typename KeyFn, typename OutFn>
__device__ void stable_rank(int n, KeyFn key_of, int* cnt, OutFn out, RankSmem& s) {
  const int tid = threadIdx.x, lane = tid & 31;
  volatile int* vc = cnt;
  for (int base = 0; base < n; base += kRankThreads) {
    const int i = base + tid;
    const int key = i < n ? key_of(i) : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    const int within = __popc(peers & ((1u << lane) - 1u));
    s.key[tid] = within == 0 ? key : -1;  // one leader a run
    s.size[tid] = __popc(peers);
    __syncthreads();
    if (tid < 32) {
      for (int w = 0; w < kRankThreads / 32; ++w) {
        const int t2 = w * 32 + tid;
        const int k = s.key[t2];
        if (k >= 0) {
          const int b = vc[k];
          vc[k] = b + s.size[t2];
          s.base[t2] = b;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    if (key >= 0) out(i, key, s.base[(tid & ~31) + __ffs(peers) - 1] + within);
    __syncthreads();
  }
}

// The member rows of each slot (slot_of(r) in [0, P), or -1 for a row of
// no slot): rank[r] within its slot (-1: not a member), slot_start [P + 1]
// and rowlist [B] (the members by (slot, row), then -1). counters: a global
// [P] scratch used when P > kSmemCounters. Returns the member count.
template <typename SlotFn>
__device__ int member_rows(int B, int P, SlotFn slot_of, int32_t* rank, int32_t* rowlist,
                           int32_t* slot_start, int32_t* counters, RankSmem& s) {
  const int tid = threadIdx.x;
  int* cnt = P <= kSmemCounters ? s.cnt : counters;
  for (int k = tid; k < P; k += kRankThreads) cnt[k] = 0;
  for (int r = tid; r < B; r += kRankThreads) rank[r] = -1;
  __syncthreads();
  stable_rank(B, slot_of, cnt, [&](int r, int, int rk) { rank[r] = rk; }, s);
  int carry = 0;
  for (int base = 0; base < P; base += kRankThreads) {
    const int p = base + tid;
    const int c = p < P ? cnt[p] : 0;
    int tc;
    const int ec = block_excl_sum(c, s.ws, &tc);
    if (p < P) slot_start[p] = carry + ec;
    carry += tc;
  }
  if (tid == 0) slot_start[P] = carry;
  __syncthreads();
  for (int r = tid; r < B; r += kRankThreads) {
    if (rank[r] >= 0) rowlist[slot_start[slot_of(r)] + rank[r]] = r;
  }
  for (int k = carry + tid; k < B; k += kRankThreads) rowlist[k] = -1;
  __syncthreads();
  return carry;
}

// The flattened place of every slot's output rows: with n_slot[p] rows out
// of slot p, n_start [P + 1] gets the items' offsets (the items listed slot
// by slot), pos_base [max n + 1] A(pos), and oidx[t] the flattened row of
// item t (position first, slot second). counters: a global [max(P, max n)]
// scratch used past kSmemCounters keys. Returns the item count R and sets
// *maxn_out to the largest n_p.
__device__ int place_by_position(int P, const int32_t* n_slot, int32_t* n_start,
                                 int32_t* pos_base, int32_t* oidx, int32_t* counters,
                                 int* maxn_out, RankSmem& s) {
  const int tid = threadIdx.x;
  if (tid == 0) { s.maxn = 0; s.live = 0; }
  __syncthreads();
  int carry_n = 0, my_max = 0, my_live = 0;
  for (int base = 0; base < P; base += kRankThreads) {
    const int p = base + tid;
    const int n = p < P ? n_slot[p] : 0;
    int tn;
    const int en = block_excl_sum(n, s.ws, &tn);
    if (p < P) n_start[p] = carry_n + en;
    carry_n += tn;
    my_max = max(my_max, n);
    my_live += n > 0;
  }
  atomicMax(&s.maxn, my_max);
  atomicAdd(&s.live, my_live);
  if (tid == 0) n_start[P] = carry_n;
  __syncthreads();
  const int R = carry_n, maxn = s.maxn, live = s.live;
  // A(pos): a histogram of n_p, then two scans in place
  for (int k = tid; k <= maxn; k += kRankThreads) pos_base[k] = 0;
  __syncthreads();
  for (int p = tid; p < P; p += kRankThreads) {
    if (n_slot[p] > 0) atomicAdd(&pos_base[n_slot[p]], 1);
  }
  __syncthreads();
  int carry_h = 0, carry_a = 0;
  for (int base = 0; base <= maxn; base += kRankThreads) {
    const int pos = base + tid;
    const int h = pos >= 1 && pos <= maxn ? pos_base[pos] : 0;
    int th, ta;
    const int held = carry_h + block_excl_sum(h, s.ws, &th) + h;  // slots with n <= pos
    const int at = pos < maxn ? live - held : 0;  // slots with a row at pos
    const int a = carry_a + block_excl_sum(at, s.ws, &ta);
    if (pos <= maxn) pos_base[pos] = a;
    carry_h += th;
    carry_a += ta;
  }
  // rank of each (pos, p) among its position's items, the items listed
  // slot by slot
  int* cnt2 = maxn <= kSmemCounters ? s.cnt : counters;
  for (int k = tid; k < maxn; k += kRankThreads) cnt2[k] = 0;
  __syncthreads();
  stable_rank(
      R, [&](int t) { return t - n_start[slot_of_item(n_start, P, t)]; }, cnt2,
      [&](int t, int pos, int rk) { oidx[t] = pos_base[pos] + rk; }, s);
  *maxn_out = maxn;
  return R;
}

// One block: the (position, slot) placement of n_slot[p] rows a slot;
// info[0] = rows, info[1] = the most rows of a slot.
__global__ void __launch_bounds__(kRankThreads)
place_kernel(int P, const int32_t* n_slot, int32_t* n_start, int32_t* pos_base, int32_t* oidx,
             int32_t* counters, int32_t* info) {
  __shared__ RankSmem s;
  int maxn;
  const int R = place_by_position(P, n_slot, n_start, pos_base, oidx, counters, &maxn, s);
  if (threadIdx.x == 0) {
    info[0] = R;
    info[1] = maxn;
  }
}

}  // namespace
