// Join probe compaction: the matched (probe row, view slot) pairs of a join
// step, in row-major order, into a fixed-capacity joined batch, for Hopper
// (sm_90a).
//
// Replaces siddhi_tpu/core/join.py CompiledJoin._assemble (:311-430) from
// the pair mask on: the outer-join miss column, the match count and the
// `join_overflow` flag, the cumsum rank of every cell of the flattened
// [R, W(+1)] mask with its scatter into `out_capacity` slots, and the
// gathers of the partner lanes (by pj, with the null fill of a missed
// partner); the probe lanes are gathered by pi with ring_view.cu's
// rv_gather_N. The on-condition itself stays a stock broadcast evaluation
// of [R, 1] x [1, W] lanes.
// Design: one warp per probe row. Pass 1 counts the row's matches (plus
// its miss cell for an outer join when it has none); one block scans the R
// counts into row offsets, the total and the overflow flag; pass 2 walks
// the row again 32 columns at a time, and each set cell takes slot
// offset + run + popc(ballot below it), so the row-major order is kept
// without a [R*W] rank array. Slots past the total become padding (pi 0,
// null partner, valid false) exactly as the JAX scatter leaves them.
// What bounds it on the card: bytes, R*W mask bytes read twice and the
// output lanes written once (about 1 MB at R = 8192, W = 100); at these
// sizes the scan block and the launches dominate.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__global__ void count_kernel(const bool* pair, const bool* row_mask, int R, int W, int outer,
                             int32_t* row_cnt) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const bool* p = pair + (size_t)row * W;
  int cnt = 0;
  for (int j = lane; j < W; j += 32) cnt += p[j];
  for (int d = 16; d > 0; d >>= 1) cnt += __shfl_down_sync(kFull, cnt, d);
  if (lane == 0) row_cnt[row] = cnt + (outer && cnt == 0 && row_mask[row]);
}

__global__ void __launch_bounds__(kBlock, 1)
offset_kernel(const int32_t* row_cnt, int R, int cap, int32_t* row_off, int32_t* n_total,
              bool* overflow) {
  __shared__ int ws[32];
  const int tid = threadIdx.x;
  long long carry = 0;
  for (int base = 0; base < R; base += kBlock) {
    const int r = base + tid;
    int tile_total;
    const int excl = block_excl_sum(r < R ? row_cnt[r] : 0, ws, &tile_total);
    if (r < R) row_off[r] = (int)(carry + excl);
    carry += tile_total;
  }
  if (tid == 0) {
    *n_total = (int)carry;
    *overflow = carry > cap;
  }
}

__global__ void fill_kernel(const bool* pair, const bool* row_mask, const int32_t* row_off,
                            int R, int W, int outer, int cap, int32_t* pi, int32_t* pj) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const bool* p = pair + (size_t)row * W;
  const int off = row_off[row];
  const unsigned below = (1u << lane) - 1u;
  int run = 0;
  for (int j0 = 0; j0 < W && off + run < cap; j0 += 32) {
    const int j = j0 + lane;
    const bool bit = j < W && p[j];
    const unsigned m = __ballot_sync(kFull, bit);
    const int slot = off + run + __popc(m & below);
    if (bit && slot < cap) {
      pi[slot] = row;
      pj[slot] = j;
    }
    run += __popc(m);
  }
  if (outer && lane == 0 && run == 0 && row_mask[row] && off < cap) {
    pi[off] = row;
    pj[off] = W;  // the miss column: a null partner
  }
}

__global__ void tail_kernel(const int32_t* n_total, int cap, int W, int32_t* pi, int32_t* pj,
                            bool* valid) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  const bool v = s < *n_total;
  valid[s] = v;
  if (!v) {
    pi[s] = 0;
    pj[s] = W;
  }
}

}  // namespace

extern "C" {

// pi/pj/valid [cap] of the matched cells of pair [R, W] (and, with outer,
// the miss column W of the rows in row_mask that matched nothing).
int jp_compact(const bool* pair, const bool* row_mask, int R, int W, int outer, int cap,
               int32_t* row_cnt, int32_t* row_off, int32_t* n_total, bool* overflow,
               int32_t* pi, int32_t* pj, bool* valid, cudaStream_t stream) {
  const int row_blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  count_kernel<<<row_blocks, kThreads, 0, stream>>>(pair, row_mask, R, W, outer, row_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  offset_kernel<<<1, kBlock, 0, stream>>>(row_cnt, R, cap, row_off, n_total, overflow);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fill_kernel<<<row_blocks, kThreads, 0, stream>>>(pair, row_mask, row_off, R, W, outer, cap,
                                                    pi, pj);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tail_kernel<<<(cap + kThreads - 1) / kThreads, kThreads, 0, stream>>>(n_total, cap, W, pi,
                                                                        pj, valid);
  return (int)cudaGetLastError();
}

// out[k] = pj[k] >= W ? null : src[pj[k]]  (null: the lane's null bit pattern)
int jp_partner_1(const void* src, const int32_t* pj, long long null_bits, void* out, int n,
                 int W, cudaStream_t stream) {
  return gather2<uint8_t>(src, nullptr, pj, null_bits, out, n, W, stream);
}
int jp_partner_4(const void* src, const int32_t* pj, long long null_bits, void* out, int n,
                 int W, cudaStream_t stream) {
  return gather2<uint32_t>(src, nullptr, pj, null_bits, out, n, W, stream);
}
int jp_partner_8(const void* src, const int32_t* pj, long long null_bits, void* out, int n,
                 int W, cudaStream_t stream) {
  return gather2<unsigned long long>(src, nullptr, pj, null_bits, out, n, W, stream);
}

}  // extern "C"
