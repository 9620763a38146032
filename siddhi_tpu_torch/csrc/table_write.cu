// K21: a table insert, for Hopper (sm_90a).
//
// Replaces siddhi_tpu/core/table.py InMemoryTable.insert + _append
// (:364-430). The JAX form builds a [B, C] key compare against the stored
// rows (8.4 * 10^9 cells at B = 8192, C = 10^6) and a [B, B] one within the
// batch, ranks the kept rows with a cumsum, takes the first B free slots
// with first_indices and scatters every lane. Here:
//   1. (primary key only) per row, one thread: an earlier live row of the
//      batch with an equal key drops it (the first row per key wins), and so
//      does a valid stored row with an equal key — found by a binary search
//      of the key column's sorted index (K22) when the caller passes one, or
//      else by a scan of the table split over blocks of 4096 slots. Keys
//      compare raw, as the JAX `==` does: NaN equals nothing, the null
//      sentinels equal themselves.
//   2. per 1024-slot tile, its number of free slots;
//   3. one block ranks the kept rows (an exclusive scan), lists them by
//      rank, scans the tile counts, and sets `next`, the overflow flag (more
//      kept rows than free slots) and the dropped-duplicate flag;
//   4. per tile, each free slot's rank among all free slots; the slot of
//      rank r < kept takes the kept row of rank r: its columns, ts, valid
//      and seq = next + r.
// The lanes are the caller's copies of the state, written in place.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"
#include "prog.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 1024;
constexpr int kChunk = 4096;
constexpr int kMaxKeys = 8;

struct Keys {
  const void* b[kMaxKeys];  // batch key columns [B]
  const void* t[kMaxKeys];  // table key columns [C]
  int ty[kMaxKeys];
  int n;
};

struct Cols {
  const void* src[kMaxLanes];  // [B]: the columns, then ts
  void* dst[kMaxLanes];        // [C]: the columns, then ts, then valid
  int size[kMaxLanes];
  int n;                       // columns
};

__device__ __forceinline__ bool key_eq_bb(const Keys& K, int i, int j) {
  for (int k = 0; k < K.n; ++k)
    if (!raw_eq(load_elem(K.b[k], i, K.ty[k]), load_elem(K.b[k], j, K.ty[k]), K.ty[k]))
      return false;
  return true;
}

__device__ __forceinline__ bool key_eq_bt(const Keys& K, int i, int c) {
  for (int k = 0; k < K.n; ++k)
    if (!raw_eq(load_elem(K.b[k], i, K.ty[k]), load_elem(K.t[k], c, K.ty[k]), K.ty[k]))
      return false;
  return true;
}

// drop[i] = 1 for a live row whose key an earlier live row or a stored row holds
__global__ void check_kernel(Keys K, const bool* rows, int B, int C, const bool* valid,
                             const int32_t* ix_order, const void* ix_sorted, int32_t* drop) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B || !rows[i]) return;
  if (blockIdx.y == 0) {
    for (int j = 0; j < i; ++j) {
      if (rows[j] && key_eq_bb(K, i, j)) {
        drop[i] = 1;
        return;
      }
    }
    if (ix_order != nullptr) {
      if (C <= 0) return;
      const int ty = K.ty[0];
      const Val x = load_elem(K.b[0], i, ty);
      const unsigned long long xk = total_key(x, ty);
      int lo = 0, hi = C;
      while (lo < hi) {
        const int mid = (int)(((unsigned int)lo + (unsigned int)hi) >> 1);
        if (total_key(load_elem(ix_sorted, mid, ty), ty) < xk) lo = mid + 1;
        else hi = mid;
      }
      const int cand = ix_order[lo < C ? lo : C - 1];
      if (valid[cand] && raw_eq(load_elem(K.t[0], cand, ty), x, ty)) drop[i] = 1;
      return;
    }
  }
  if (ix_order != nullptr) return;
  const int c0 = blockIdx.y * kChunk;
  const int c1 = c0 + kChunk < C ? c0 + kChunk : C;
  for (int c = c0; c < c1; ++c) {
    if (valid[c] && key_eq_bt(K, i, c)) {
      drop[i] = 1;
      return;
    }
  }
}

__global__ void free_count_kernel(const bool* valid, int C, int32_t* tile_cnt) {
  const int c = blockIdx.x * kTile + threadIdx.x;
  const int n = __syncthreads_count(c < C && !valid[c]);
  if (threadIdx.x == 0) tile_cnt[blockIdx.x] = n;
}

__global__ void rank_kernel(const bool* rows, const int32_t* drop, int B, int npk,
                            int32_t* row_of_rank, const int32_t* tile_cnt, int32_t* tile_off,
                            int tiles, const int64_t* next_in, int64_t* next_out, bool* overflow,
                            bool* pk_dup, int32_t* meta) {
  __shared__ int ws[32];
  int carry = 0, dup = 0;
  for (int base = 0; base < B; base += kTile) {
    const int i = base + threadIdx.x;
    const bool live = i < B && rows[i];
    const bool keep = live && !(npk > 0 && drop[i]);
    dup |= live && !keep;
    int total;
    const int r = carry + block_excl_sum(keep ? 1 : 0, ws, &total);
    if (keep) row_of_rank[r] = i;
    carry += total;
  }
  int fcarry = 0;
  for (int base = 0; base < tiles; base += kTile) {
    const int t = base + threadIdx.x;
    const int v = t < tiles ? tile_cnt[t] : 0;
    int total;
    const int o = fcarry + block_excl_sum(v, ws, &total);
    if (t < tiles) tile_off[t] = o;
    fcarry += total;
  }
  const int any_dup = __syncthreads_or(dup);
  if (threadIdx.x == 0) {
    meta[0] = carry;
    *next_out = *next_in + carry;
    *overflow = carry > fcarry;
    *pk_dup = any_dup != 0;
  }
}

__global__ void scatter_kernel(Cols L, const bool* valid, int C, const int32_t* tile_off,
                               const int32_t* row_of_rank, const int32_t* meta,
                               const int64_t* next_in, int64_t* seq) {
  __shared__ int ws[32];
  const int c = blockIdx.x * kTile + threadIdx.x;
  const bool f = c < C && !valid[c];
  int total;
  const int r = tile_off[blockIdx.x] + block_excl_sum(f ? 1 : 0, ws, &total);
  if (!f || r >= meta[0]) return;
  const int row = row_of_rank[r];
  for (int l = 0; l <= L.n; ++l) {  // the columns, then ts
    switch (L.size[l]) {
      case 1: ((uint8_t*)L.dst[l])[c] = ((const uint8_t*)L.src[l])[row]; break;
      case 4: ((uint32_t*)L.dst[l])[c] = ((const uint32_t*)L.src[l])[row]; break;
      default:
        ((unsigned long long*)L.dst[l])[c] = ((const unsigned long long*)L.src[l])[row];
        break;
    }
  }
  ((bool*)L.dst[L.n + 1])[c] = true;
  seq[c] = *next_in + r;
}

}  // namespace

extern "C" {

// Insert the rows of a batch (rows [B]) into a table of C slots. Key
// columns: npk of them, batch (pk_b) and table (pk_t) arrays of type pk_ty;
// ix_order/ix_sorted: the single key column's sorted index, or null. src:
// ncols batch columns then ts [B]; dst: ncols table columns, ts, valid [C]
// (copies of the state, written in place), with element sizes dst_size.
// seq [C] in place; next_out = next_in + kept rows; overflow and pk_dup
// 0-d bools. scratch: int32 [2B + 2 * ceil(C / 1024) + 4].
int tw_insert(const bool* rows, int B, int C, const bool* valid, int npk,
              const void* const* pk_b, const void* const* pk_t, const int* pk_size,
              const int* pk_ty, const int32_t* ix_order, const void* ix_sorted, int ncols,
              const void* const* src, void* const* dst, const int* dst_size,
              const int64_t* next_in, int64_t* seq, int64_t* next_out, bool* overflow,
              bool* pk_dup, int32_t* scratch, cudaStream_t stream) {
  (void)pk_size;
  if (npk > kMaxKeys || ncols + 2 > kMaxLanes) return (int)cudaErrorInvalidValue;
  const int tiles = (C + kTile - 1) / kTile;
  int32_t* drop = scratch;
  int32_t* row_of_rank = scratch + B;
  int32_t* tile_cnt = scratch + 2 * B;
  int32_t* tile_off = tile_cnt + tiles;
  int32_t* meta = tile_off + tiles;
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)(2 * B + 2 * tiles + 4) * 4, stream);
  if (err != cudaSuccess) return (int)err;
  if (npk > 0 && B > 0) {
    Keys K;
    K.n = npk;
    for (int k = 0; k < kMaxKeys; ++k) {
      K.b[k] = k < npk ? pk_b[k] : nullptr;
      K.t[k] = k < npk ? pk_t[k] : nullptr;
      K.ty[k] = k < npk ? pk_ty[k] : 0;
    }
    const int chunks = ix_order != nullptr ? 1 : (C + kChunk - 1) / kChunk;
    dim3 g((B + kThreads - 1) / kThreads, chunks > 0 ? chunks : 1);
    check_kernel<<<g, kThreads, 0, stream>>>(K, rows, B, C, valid, ix_order, ix_sorted, drop);
  }
  if (tiles > 0) free_count_kernel<<<tiles, kTile, 0, stream>>>(valid, C, tile_cnt);
  rank_kernel<<<1, kTile, 0, stream>>>(rows, drop, B, npk, row_of_rank, tile_cnt, tile_off,
                                        tiles, next_in, next_out, overflow, pk_dup, meta);
  if (tiles > 0) {
    Cols L;
    L.n = ncols;
    for (int l = 0; l < kMaxLanes; ++l) {
      L.src[l] = l <= ncols ? src[l] : nullptr;
      L.dst[l] = l <= ncols + 1 ? dst[l] : nullptr;
      L.size[l] = l <= ncols + 1 ? dst_size[l] : 0;
    }
    scatter_kernel<<<tiles, kTile, 0, stream>>>(L, valid, C, tile_off, row_of_rank, meta,
                                                 next_in, seq);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
