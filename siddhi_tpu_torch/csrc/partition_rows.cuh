// The row lists of a keyed step, for Hopper (sm_90a): each slot's member
// rows and the TIMER rows of a batch, which the partitioned time and batch
// windows (K31 and K32, both through csrc/partition_time.cu `pt_rows`) and
// the keyed pattern scan (K37, through ops/partition.py `partition_rows`)
// take.
//
// Replaces the vmap's masks of siddhi_tpu/core/partition.py:356 (a row of
// slot p is a member of lane p) with lists: rowlist [B] the member rows (a
// valid CURRENT row whose slot lies in [0, P)) by (slot, row), then -1;
// slot_start [P + 1]; rank [B] a member row's place in its slot's list
// (-1 for the rest); timers [B] the valid TIMER rows in row order (then
// unspecified); rows [P] each slot's member count; info[2]
// the member rows, info[3] the TIMER rows (info[0] and info[1], which the
// placement fills, zeroed).
//
// All of it is one stable sort of the rows by one key: the slot for a
// member row, P for a TIMER row, P + 1 for the rest. Its order is rowlist,
// then the TIMER rows in row order, then the rest. csrc/radix_sort.cuh
// sorts: above one tile (2,048 rows) its cooperative grid sort, whose
// phase 1 also counts each key into a [P + 2] histogram (warp-aggregated
// atomics); block 0 scans it into slot_start once phase 1's barrier has
// passed, and the last pass writes rowlist, rank and timers from each row's
// final place. Only the key's ceil(log2(P + 2) / 8) low bytes can vary, and
// the sort skips the others on the device: two passes at P = 1,024. Up to
// one tile, its one-block sort in shared memory, with slot_start found by
// binary search over the sorted keys. Bound: bytes, the three [B] input
// lanes read and the four [B] lanes written (about 1 MB at B = 32,768); the
// grid barriers and the launch dominate at that size.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "radix_sort.cuh"

namespace {

// A row's sort key: its slot (member), P (TIMER) or P + 1 (the rest).
struct RowKeys {
  const int8_t* kind;
  const bool* valid;
  const int32_t* slot;
  int P;
  __device__ __forceinline__ int key(int r) const {
    if (!valid[r]) return P + 1;
    if (kind[r] == 0) {
      const int sl = slot[r];
      return sl >= 0 && sl < P ? sl : P + 1;
    }
    return kind[r] == 2 ? P : P + 1;
  }
};

struct RowLists {
  int32_t* rank;
  int32_t* rowlist;
  int32_t* slot_start;
  int32_t* timers;
  int32_t* rows;
  int32_t* info;
  // row r (of sort key `key`) at place `at` of the order, once slot_start
  // is written
  __device__ __forceinline__ void put(int at, int r, int key, int P) const {
    if (key < P) {
      rowlist[at] = r;
      rank[r] = at - __ldcg(slot_start + key);
    } else {
      rowlist[at] = -1;
      rank[r] = -1;
      if (key == P) timers[at - __ldcg(slot_start + P)] = r;
    }
  }
};

// The grid sort's word: the row's key, counted into bins (asked once a row).
struct CountedRowWord {
  RowKeys k;
  unsigned* bins;  // [P + 2], zero on entry
  __device__ __forceinline__ unsigned long long operator()(int, int r) const {
    const int key = k.key(r);
    const unsigned peers = __match_any_sync(__activemask(), key);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(bins + key, (unsigned)__popc(peers));
    return (unsigned long long)key;
  }
};

// Above one tile: one cooperative launch of kSortThreads-thread blocks.
__global__ void __launch_bounds__(kSortThreads)
rows_grid_kernel(int B, RowKeys k, RowLists out, unsigned* bins, RadixWork wk) {
  __shared__ GridSmem s;
  __shared__ int ws[32];
  __shared__ int tile_total;
  cg::grid_group grid = cg::this_grid();
  const int P = k.P, tid = threadIdx.x;
  for (int x = blockIdx.x * kSortThreads + tid; x < P + 2; x += gridDim.x * kSortThreads)
    bins[x] = 0u;
  grid.sync();
  auto starts = [&]() {  // block 0: slot_start from the counts, and info
    if (blockIdx.x != 0) return;
    int carry = 0;
    for (int base = 0; base <= P; base += kSortThreads) {
      const int q = base + tid;
      const int c = q < P ? (int)__ldcg(bins + q) : 0;
      const int e = block_excl_sum(c, ws, &tile_total);
      if (q <= P) out.slot_start[q] = carry + e;
      if (q < P) out.rows[q] = c;
      carry += tile_total;
    }
    if (tid == 0) {
      out.info[0] = out.info[1] = 0;
      out.info[2] = carry;
      out.info[3] = (int)__ldcg(bins + P);
    }
  };
  radix_sort_grid(B, 1, CountedRowWord{k, bins}, wk, s,
                  [&](int at, int r) { out.put(at, r, k.key(r), P); }, starts);
}

union RowTileSmem {
  TileSmem<kBlockSortThreads, kBlockSortIPT> t;
  unsigned long long red[2][kMaxSortWords][32];
};

// The first sorted place whose key is at least q (keys ascending).
__device__ __forceinline__ int lower_bound_key(const unsigned long long* keys, int n, int q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < (unsigned long long)q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Up to one tile: the sort and the lists in one block.
__global__ void __launch_bounds__(kBlockSortThreads)
rows_tile_kernel(int B, RowKeys k, RowLists out) {
  __shared__ RowTileSmem u;
  __shared__ PassList pl;
  const int P = k.P, tid = threadIdx.x;
  radix_sort_block<kBlockSortThreads, kBlockSortIPT>(
      B, 1, [&](int, int r) { return (unsigned long long)k.key(r); }, u.t, u.red, pl);
  for (int i = tid; i < B; i += kBlockSortThreads)
    u.t.key[i] = (unsigned long long)k.key(u.t.val[i]);
  __syncthreads();
  for (int q = tid; q <= P; q += kBlockSortThreads)
    out.slot_start[q] = lower_bound_key(u.t.key, B, q);
  if (tid == 0) {
    const int C = lower_bound_key(u.t.key, B, P);
    out.info[0] = out.info[1] = 0;
    out.info[2] = C;
    out.info[3] = lower_bound_key(u.t.key, B, P + 1) - C;
  }
  __syncthreads();
  for (int i = tid; i < B; i += kBlockSortThreads) out.put(i, u.t.val[i], (int)u.t.key[i], P);
  for (int q = tid; q < P; q += kBlockSortThreads)
    out.rows[q] = __ldcg(out.slot_start + q + 1) - __ldcg(out.slot_start + q);
}

// The workspace of the row lists of B rows (base null: only its size).
inline size_t rows_carve(char* base, int B, int P, RadixWork* rw, unsigned** bins) {
  Carve c{base, 0};
  if (B > kSortTile) {
    *rw = carve_radix(c, B, 1);
    *bins = c.take<unsigned>((size_t)P + 2);
  }
  return c.off + 256;
}

// The row lists on `stream` (B >= 1, P >= 1); work: rows_carve's bytes.
inline int launch_rows(const int8_t* kind, const bool* valid, const int32_t* slot, int B, int P,
                       int32_t* rank, int32_t* rowlist, int32_t* slot_start, int32_t* timers,
                       int32_t* rows, int32_t* info, void* work, cudaStream_t stream) {
  if (B < 1 || B >= kMaxGridRows || P < 1 || P >= (1 << 30)) return (int)cudaErrorInvalidValue;
  RowKeys k{kind, valid, slot, P};
  RowLists out{rank, rowlist, slot_start, timers, rows, info};
  if (B <= kSortTile) {
    rows_tile_kernel<<<1, kBlockSortThreads, 0, stream>>>(B, k, out);
    return (int)cudaGetLastError();
  }
  RadixWork rw{};
  unsigned* bins = nullptr;
  rows_carve((char*)work, B, P, &rw, &bins);
  int blocks = 0;
  cudaError_t err = coop_blocks(rows_grid_kernel, B, &blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&B, &k, &out, &bins, &rw};
  err = cudaLaunchCooperativeKernel((const void*)rows_grid_kernel, dim3(blocks),
                                    dim3(kSortThreads), args, 0, stream);
  return (int)err;
}

}  // namespace
