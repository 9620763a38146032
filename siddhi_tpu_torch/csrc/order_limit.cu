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
// A stable LSD radix sort then orders the rows by (partition, invalid, key
// 1, ..., key n), least significant byte first, skipping every byte that no
// row changes (an OR and an AND of each word over the rows); the invalid
// rows, which are never delivered, follow the valid ones in row order. Each pass is
// a stable counting pass of `partition.cuh` (`stable_rank`) in one block.
// The partitioned entry then places the sorted rows with `partition.cuh`'s
// (position, slot) placement; the offset/limit keeps ranks [lo, hi) among a
// partition's (or the chunk's) valid rows, which the sort puts first.
//
// Bound: bytes (the keys read once, the permutation and mask written
// once). Design: simple and exact first — one block walks every pass, so a
// pass costs ~R/1024 block barriers; a top-k for small limits and a
// multi-block radix sort are later speed work.

#include <cstdint>
#include <cuda_runtime.h>

#include "partition.cuh"

namespace {

constexpr int kMaxKeys = 8;
constexpr int kEncodeThreads = 256;

struct OrderKeys {
  const void* col[kMaxKeys];
  int code[kMaxKeys];  // 0 int32, 1 int64, 2 bool, 3 float32
  int desc[kMaxKeys];
};

__device__ __forceinline__ unsigned long long enc_f32(float f) {
  if (isnan(f)) return 0xFFFFFFFFull;  // after +inf (0xFF800000)
  unsigned u = __float_as_uint(f);
  if ((u & 0x7f800000u) == 0u) u = 0u;  // -0.0 and subnormals tie 0.0
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

// words[w * R + r]: row r's word w, the most significant first (the
// partition when there is one, then the invalid flag, then the keys);
// wor/wand[w] the OR and the AND of word w over the rows.
__global__ void encode_kernel(int R, int nk, OrderKeys k, const bool* valid,
                              const long long* part, unsigned long long* words,
                              unsigned long long* wor, unsigned long long* wand) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < R;
  int w = 0;
  auto put = [&](unsigned long long code) {
    if (live) words[(size_t)w * R + r] = code;
    unsigned long long o = live ? code : 0ull, a = live ? code : ~0ull;
    for (int d = 16; d > 0; d >>= 1) {
      o |= __shfl_xor_sync(kFull, o, d);
      a &= __shfl_xor_sync(kFull, a, d);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicOr(&wor[w], o);
      atomicAnd(&wand[w], a);
    }
    ++w;
  };
  if (part != nullptr) put(live ? (unsigned long long)part[r] : 0ull);
  put(live && !valid[r] ? 1ull : 0ull);
  // an invalid row's keys are 0: the invalid rows follow in row order, and a
  // chunk with none valid (a join side that does not trigger) sorts nothing
  const bool keyed = live && valid[r];
  for (int j = 0; j < nk; ++j) put(keyed ? enc_key(k.col[j], k.code[j], k.desc[j], r) : 0ull);
}

// One block: the sort (when nw > 0), then the placement and the limit.
__global__ void __launch_bounds__(kRankThreads)
order_kernel(int R, int nw, const unsigned long long* words, const unsigned long long* wor,
             const unsigned long long* wand, const bool* valid, const long long* part, int P,
             int lo, int hi, int32_t* pa, int32_t* pb, int32_t* perm_out, bool* valid_out,
             int32_t* n_slot, int32_t* n_start, int32_t* pos_base, int32_t* oidx,
             int32_t* counters) {
  __shared__ RankSmem s;
  const int tid = threadIdx.x;
  if (nw == 0) {
    // offset/limit alone: the row order stays, ranks among the valid rows
    // (of each partition)
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
    return;
  }
  for (int i = tid; i < R; i += kRankThreads) pa[i] = i;
  __syncthreads();
  int32_t* in = pa;
  int32_t* out = pb;
  for (int w = nw - 1; w >= 0; --w) {
    const unsigned long long diff = wor[w] ^ wand[w];
    const unsigned long long* kw = words + (size_t)w * R;
    for (int b = 0; b < 8; ++b) {
      const int sh = 8 * b;
      if (((diff >> sh) & 0xffull) == 0ull) continue;  // no row changes this byte
      for (int d = tid; d < 256; d += kRankThreads) s.cnt[d] = 0;
      __syncthreads();
      for (int i = tid; i < R; i += kRankThreads) {
        atomicAdd(&s.cnt[(int)((kw[in[i]] >> sh) & 0xffull)], 1);
      }
      __syncthreads();
      int tot;
      const int c = tid < 256 ? s.cnt[tid] : 0;
      const int e = block_excl_sum(c, s.ws, &tot);
      if (tid < 256) s.cnt[tid] = e;
      __syncthreads();
      const int32_t* cin = in;
      int32_t* cout = out;
      stable_rank(
          R, [&](int i) { return (int)((kw[cin[i]] >> sh) & 0xffull); }, s.cnt,
          [&](int i, int, int rk) { cout[rk] = cin[i]; }, s);
      in = cout;
      out = const_cast<int32_t*>(cin);
    }
  }
  if (part == nullptr) {
    // the valid rows come first: a valid row's rank is its position
    for (int i = tid; i < R; i += kRankThreads) {
      const int r = in[i];
      perm_out[i] = r;
      valid_out[i] = valid[r] && i >= lo && i < hi;
    }
    return;
  }
  // the rows sorted by partition: each partition's run, placed by
  // (position within the partition, partition) as `_flatten` does
  for (int q = tid; q <= P; q += kRankThreads) n_slot[q] = 0;
  __syncthreads();
  for (int i = tid; i < R; i += kRankThreads) atomicAdd(&n_slot[(int)part[i]], 1);
  __syncthreads();
  int maxn;
  place_by_position(P + 1, n_slot, n_start, pos_base, oidx, counters, &maxn, s);
  __syncthreads();
  for (int t = tid; t < R; t += kRankThreads) {
    const int r = in[t];
    const int rk = t - n_start[(int)part[r]];
    const int o = oidx[t];
    perm_out[o] = r;
    valid_out[o] = valid[r] && rk >= lo && rk < hi;
  }
}

}  // namespace

// nk keys (0: offset/limit alone); part: null for the flat entry, else each
// row's partition in [0, P] (P: a row of no partition). Scratch: words
// [(nk + 2) * R] u64, wor/wand [2 * (kMaxKeys + 2)] u64, pa/pb [R],
// n_slot/n_start [P + 2], pos_base [R + 1], oidx [R], counters
// [max(P + 2, R + 1)] int32.
extern "C" int ol_order(int R, int nk, int P, int lo, int hi, const void* valid,
                        const void* part, const void* k0, const void* k1, const void* k2,
                        const void* k3, const void* k4, const void* k5, const void* k6,
                        const void* k7, int c0, int c1, int c2, int c3, int c4, int c5, int c6,
                        int c7, int d0, int d1, int d2, int d3, int d4, int d5, int d6, int d7,
                        void* words, void* worand, void* pa, void* pb, void* perm_out,
                        void* valid_out, void* n_slot, void* n_start, void* pos_base, void* oidx,
                        void* counters, void* stream) {
  if (R < 0 || nk < 0 || nk > kMaxKeys || P < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const long long* pt = (const long long*)part;
  int nw = 0;
  auto* wor = (unsigned long long*)worand;
  auto* wand = wor + (kMaxKeys + 2);
  if (nk > 0) {
    nw = nk + 1 + (pt != nullptr ? 1 : 0);
    cudaError_t err = cudaMemsetAsync(wor, 0, nw * sizeof(unsigned long long), st);
    if (err == cudaSuccess) err = cudaMemsetAsync(wand, 0xff, nw * sizeof(unsigned long long), st);
    if (err != cudaSuccess) return (int)err;
    OrderKeys k{{k0, k1, k2, k3, k4, k5, k6, k7}, {c0, c1, c2, c3, c4, c5, c6, c7},
                {d0, d1, d2, d3, d4, d5, d6, d7}};
    encode_kernel<<<(R + kEncodeThreads - 1) / kEncodeThreads, kEncodeThreads, 0, st>>>(
        R, nk, k, (const bool*)valid, pt, (unsigned long long*)words, wor, wand);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  order_kernel<<<1, kRankThreads, 0, st>>>(
      R, nw, (const unsigned long long*)words, wor, wand, (const bool*)valid, pt, P, lo, hi,
      (int32_t*)pa, (int32_t*)pb, (int32_t*)perm_out, (bool*)valid_out, (int32_t*)n_slot,
      (int32_t*)n_start, (int32_t*)pos_base, (int32_t*)oidx, (int32_t*)counters);
  return (int)cudaGetLastError();
}
