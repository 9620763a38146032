// K46: order-by with offset/limit over a chunk of output rows, flat and
// within each partition.
//
// Replaces siddhi_tpu/core/selector.py:261 `Selector._order_limit` (the
// XLA-compiled `jnp.lexsort` over (valid rows first, key 1, ..., key n) and
// the offset/limit by rank among the valid rows), and the same under the
// partition vmap (siddhi_tpu/core/partition.py `_vmapped`), whose rows the
// port places by (rank within the partition, slot) as `_flatten` does.
//
// Each key is encoded into an order-preserving unsigned 64-bit word exactly
// as the JAX package orders it: int32/int64 as two's complement with the
// sign bit flipped (`desc` negates first with wraparound, so INT_MIN stays
// first); float32 with -0.0 and the subnormals folded onto 0.0 (they tie,
// row order decides, as XLA's comparisons flush subnormals) and every NaN,
// whatever its sign, after +inf, also after a `desc` negation; bool as
// 0/1, `desc` through -float32(b); strings by interned id.
// `radix_sort.cuh` then orders the rows stably by the words (partition,
// invalid, key 1, ..., key n), skipping every byte that no row changes; the
// invalid rows, which are never delivered, follow the valid ones in row
// order. Up to one tile of rows (2,048) one block encodes and sorts in
// shared memory; above it one cooperative launch sorts over the grid and
// its last pass writes the flat entry's permutation and kept mask. The
// partitioned entry then places the sorted rows with `partition.cuh`'s
// (position, slot) placement, in the same block up to one tile, else in one
// more block; the offset/limit keeps ranks [lo, hi) among a partition's (or
// the chunk's) valid rows, which the sort puts first.
//
// Bound: bytes (the keys read once, the permutation and mask written once);
// each pass moves the current word and the row once each way.

#include <cstdint>
#include <cuda_runtime.h>

#include "partition.cuh"
#include "radix_sort.cuh"

namespace {

constexpr int kMaxKeys = 8;
static_assert(kMaxKeys + 2 <= kMaxSortWords, "the partition, invalid and key words");
static_assert(kRankThreads == kBlockSortThreads, "the one-block sort places in its block");

struct OrderKeys {
  const void* col[kMaxKeys];
  int code[kMaxKeys];  // 0 int32, 1 int64, 2 bool, 3 float32
  int desc[kMaxKeys];
};

__device__ __forceinline__ unsigned long long enc_f32(float f) {
  if (isnan(f)) return 0xFFFFFFFFull;  // after +inf (0xFF800000)
  unsigned u = __float_as_uint(f);
  if (is_subnormal_or_zero(u)) u = 0u;  // -0.0 and subnormals tie 0.0
  return (u & 0x80000000u) ? (unsigned long long)(~u) : (unsigned long long)(u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long enc_key(const void* p, int code, int desc, int r) {
  switch (code) {
    case 0: {
      uint32_t x = static_cast<const uint32_t*>(p)[r];
      if (desc) x = 0u - x;  // int32 negation, wrapping
      return (unsigned long long)(x ^ 0x80000000u);
    }
    case 1: {
      unsigned long long x = static_cast<const unsigned long long*>(p)[r];
      if (desc) x = 0ull - x;  // int64 negation, wrapping
      return x ^ 0x8000000000000000ull;
    }
    case 2: {
      const bool b = static_cast<const bool*>(p)[r];
      if (desc) return enc_f32(b ? -1.0f : -0.0f);
      return b ? 1ull : 0ull;
    }
    default: {
      float f = static_cast<const float*>(p)[r];
      if (desc) f = -f;
      return enc_f32(f);
    }
  }
}

// Row r's word w, the most significant first: the partition when there is
// one, then the invalid flag, then the keys (an invalid row's keys are 0:
// the invalid rows follow in row order, and a chunk with none valid, such as
// a join side that does not trigger, sorts nothing).
struct OrderWords {
  OrderKeys k;
  const bool* valid;
  const long long* part;
  __device__ unsigned long long operator()(int w, int r) const {
    if (part != nullptr) {
      if (w == 0) return (unsigned long long)part[r];
      --w;
    }
    if (!valid[r]) return w == 0 ? 1ull : 0ull;
    return w == 0 ? 0ull : enc_key(k.col[w - 1], k.code[w - 1], k.desc[w - 1], r);
  }
};

// The flat entry's output at place i of the order: row r, kept when valid
// and ranked [lo, hi) (the valid rows come first: a valid row's rank is its
// place).
struct OrderOut {
  const bool* valid;
  int lo, hi;
  int32_t* perm;
  bool* kept;
  __device__ void put(int i, int r) const {
    perm[i] = r;
    kept[i] = valid[r] && i >= lo && i < hi;
  }
};

// The partitioned entry's scratch: the rows in sorted order, and the
// placement's counts and offsets.
struct PlaceScratch {
  int32_t* sorted;    // [R]
  int32_t* n_slot;    // [P + 2]
  int32_t* n_start;   // [P + 2]
  int32_t* pos_base;  // [R + 1]
  int32_t* oidx;      // [R]
  int32_t* counters;  // [max(P + 2, R + 1)]
};

// The rows in sorted order (sorted by partition first), each partition's
// run placed by (position within the partition, partition) as `_flatten`
// does. Every thread of a kRankThreads block calls it.
__device__ void place_sorted(int R, const bool* valid, const long long* part, int P, int lo,
                             int hi, const OrderOut& out, const PlaceScratch& ps, RankSmem& s) {
  const int tid = threadIdx.x;
  for (int q = tid; q <= P; q += kRankThreads) ps.n_slot[q] = 0;
  __syncthreads();
  for (int i = tid; i < R; i += kRankThreads) atomicAdd(&ps.n_slot[(int)part[i]], 1);
  __syncthreads();
  int maxn;
  place_by_position(P + 1, ps.n_slot, ps.n_start, ps.pos_base, ps.oidx, ps.counters, &maxn, s);
  __syncthreads();
  for (int t = tid; t < R; t += kRankThreads) {
    const int r = ps.sorted[t];
    const int rk = t - ps.n_start[(int)part[r]];
    const int o = ps.oidx[t];
    out.perm[o] = r;
    out.kept[o] = valid[r] && rk >= lo && rk < hi;
  }
}

// No key: the offset/limit alone, the row order kept, ranks among the valid
// rows (of each partition). One block.
__global__ void __launch_bounds__(kRankThreads)
ol_limit_kernel(int R, const bool* valid, const long long* part, int P, int lo, int hi,
                int32_t* perm_out, bool* valid_out, int32_t* counters) {
  __shared__ RankSmem s;
  const int tid = threadIdx.x;
  for (int i = tid; i < R; i += kRankThreads) {
    perm_out[i] = i;
    valid_out[i] = false;
  }
  if (part == nullptr) {
    int carry = 0;
    for (int base = 0; base < R; base += kRankThreads) {
      const int i = base + tid;
      const int f = i < R && valid[i] ? 1 : 0;
      int tot;
      const int rk = carry + block_excl_sum(f, s.ws, &tot);
      if (f) valid_out[i] = rk >= lo && rk < hi;
      carry += tot;
    }
    return;
  }
  int* cnt = P + 1 <= kSmemCounters ? s.cnt : counters;
  for (int k2 = tid; k2 <= P; k2 += kRankThreads) cnt[k2] = 0;
  __syncthreads();
  stable_rank(
      R, [&](int i) { return valid[i] ? (int)part[i] : -1; }, cnt,
      [&](int i, int, int rk) { valid_out[i] = rk >= lo && rk < hi; }, s);
}

union TileOrderSmem {
  TileSmem<kBlockSortThreads, kBlockSortIPT> t;
  unsigned long long red[2][kMaxSortWords][32];
  RankSmem rank;
};

// Up to one tile of rows: the encode, the sort and the output (the
// placement too, partitioned) in one block.
__global__ void __launch_bounds__(kBlockSortThreads)
ol_tile_kernel(int R, int nw, OrderWords words, int P, OrderOut out, PlaceScratch ps) {
  __shared__ TileOrderSmem u;
  __shared__ PassList pl;
  radix_sort_block<kBlockSortThreads, kBlockSortIPT>(R, nw, words, u.t, u.red, pl);
  const int tid = threadIdx.x;
  if (words.part == nullptr) {
    for (int i = tid; i < R; i += kBlockSortThreads) out.put(i, u.t.val[i]);
    return;
  }
  for (int i = tid; i < R; i += kBlockSortThreads) ps.sorted[i] = u.t.val[i];
  __syncthreads();  // the sort's shared memory becomes the placement's
  place_sorted(R, words.valid, words.part, P, out.lo, out.hi, out, ps, u.rank);
}

// Above one tile: the sort over the grid (cooperative launch); the flat
// entry's output from its last pass, the partitioned entry's sorted rows.
__global__ void __launch_bounds__(kSortThreads)
ol_grid_kernel(int R, int nw, OrderWords words, OrderOut out, int32_t* sorted, RadixWork wk) {
  __shared__ GridSmem s;
  if (words.part == nullptr) {
    radix_sort_grid(R, nw, words, wk, s, [&](int i, int r) { out.put(i, r); });
  } else {
    radix_sort_grid(R, nw, words, wk, s, [&](int i, int r) { sorted[i] = r; });
  }
}

// The partitioned entry's placement after the grid sort: one block.
__global__ void __launch_bounds__(kRankThreads)
ol_place_kernel(int R, const bool* valid, const long long* part, int P, OrderOut out,
                PlaceScratch ps) {
  __shared__ RankSmem s;
  place_sorted(R, valid, part, P, out.lo, out.hi, out, ps, s);
}

// The workspace of a call: its layout (base null: only its size).
size_t ol_carve(char* base, int R, int nk, int P, bool partitioned, RadixWork* rw,
                PlaceScratch* ps) {
  Carve c{base, 0};
  const int nw = nk > 0 ? nk + 1 + (partitioned ? 1 : 0) : 0;
  if (nw > 0 && R > kSortTile) *rw = carve_radix(c, R, nw);
  if (partitioned) {
    ps->sorted = c.take<int32_t>((size_t)R);
    ps->n_slot = c.take<int32_t>((size_t)P + 2);
    ps->n_start = c.take<int32_t>((size_t)P + 2);
    ps->pos_base = c.take<int32_t>((size_t)R + 1);
    ps->oidx = c.take<int32_t>((size_t)R);
    ps->counters = c.take<int32_t>((size_t)(P + 2 > R + 1 ? P + 2 : R + 1));
  }
  return c.off + 256;
}

}  // namespace

extern "C" {

// The bytes of ol_order's workspace for R rows, nk keys and P partitions
// (partitioned: 0 for the flat entry).
long long ol_workspace(int R, int nk, int P, int partitioned) {
  RadixWork rw;
  PlaceScratch ps;
  return (long long)ol_carve(nullptr, R < 0 ? 0 : R, nk, P < 0 ? 0 : P, partitioned != 0, &rw,
                             &ps);
}

// nk keys (0: offset/limit alone); codes: key j's type code (0 int32, 1
// int64, 2 bool, 3 float32) in bits 3j..3j+1 and its `desc` flag in bit
// 3j+2; part: null for the flat entry, else each row's partition in [0, P]
// (P: a row of no partition). perm_out int32 [R], valid_out bool [R]; work:
// ol_workspace(R, nk, P, part != null) bytes.
int ol_order(int R, int nk, int P, int lo, int hi, int codes, const void* valid,
             const void* part, const void* k0, const void* k1, const void* k2, const void* k3,
             const void* k4, const void* k5, const void* k6, const void* k7, void* perm_out,
             void* valid_out, void* work, void* stream) {
  if (R < 0 || R >= kMaxGridRows || nk < 0 || nk > kMaxKeys || P < 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* pt = (const long long*)part;
  const bool* vd = (const bool*)valid;
  RadixWork rw{};
  PlaceScratch ps{};
  ol_carve((char*)work, R, nk, P, pt != nullptr, &rw, &ps);
  OrderOut out{vd, lo, hi, (int32_t*)perm_out, (bool*)valid_out};
  if (nk == 0) {
    ol_limit_kernel<<<1, kRankThreads, 0, st>>>(R, vd, pt, P, lo, hi, out.perm, out.kept,
                                                ps.counters);
    return (int)cudaGetLastError();
  }
  OrderWords words{{{k0, k1, k2, k3, k4, k5, k6, k7}, {}, {}}, vd, pt};
  for (int j = 0; j < kMaxKeys; ++j) {
    words.k.code[j] = (codes >> (3 * j)) & 3;
    words.k.desc[j] = (codes >> (3 * j + 2)) & 1;
  }
  int nw = nk + 1 + (pt != nullptr ? 1 : 0);
  if (R <= kSortTile) {
    ol_tile_kernel<<<1, kBlockSortThreads, 0, st>>>(R, nw, words, P, out, ps);
    return (int)cudaGetLastError();
  }
  int blocks = 0;
  cudaError_t err = coop_blocks(ol_grid_kernel, R, &blocks);
  if (err != cudaSuccess) return (int)err;
  int32_t* sorted = ps.sorted;
  void* args[] = {&R, &nw, &words, &out, &sorted, &rw};
  err = cudaLaunchCooperativeKernel((const void*)ol_grid_kernel, dim3(blocks), dim3(kSortThreads),
                                    args, 0, st);
  if (err != cudaSuccess) return (int)err;
  if (pt != nullptr) ol_place_kernel<<<1, kRankThreads, 0, st>>>(R, vd, pt, P, out, ps);
  return (int)cudaGetLastError();
}

}  // extern "C"
