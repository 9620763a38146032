// Fused-ingest deliver pack for Hopper (sm_90a): stable compaction of the
// deliverable output rows of K micro-batches into one row-major byte buffer.
//
// Replaces the deliver pack of siddhi_tpu/core/ingest.py _build.fused (after
// its lax.scan): a cumsum rank over the flattened [K, R] deliverable mask,
// ops/scatter.py set_at of every lane into its rank, a bitcast of each lane
// to bytes, a concatenate into [K*R, W] rows, and header rows in front that
// hold the int32 per-micro-batch counts. The host then copies the header and
// the filled row prefix back once per chunk.
//
// Output: u8 [hdr_rows + K*R, W]. Bytes [0, 4K) of the header are the K
// counts (little-endian int32), the rest of the header is zero; kept row j
// (in arrival order over all K*R rows) is row hdr_rows + j, its lanes' bytes
// side by side at their offsets (bool lanes as one 0/1 byte); rows past the
// total are zero.
//
// Three launches, no host sync:
//   1. count: one block per (tile of kThreads rows, k) counts its kept rows;
//   2. scan: one block turns the K*T tile counts into exclusive offsets,
//      writes the header and the total;
//   3. scatter: one block per tile ranks its rows with a block scan and
//      copies each kept row's W bytes; rows at or past the total in its own
//      range of the K*R flat positions are zeroed.
// Rows are W bytes wide (W = 17 once an int8 kind lane is in), so every row
// start is byte-aligned only: the rows are written byte by byte.
// What bounds it on the card: bytes (dv and every lane read once, the kept
// rows written once); at K = 32, R = 65536 with the quickstart avg app
// (W = 16, about 16384 kept rows a micro-batch) that is some 35 MiB in and
// 8 MiB out, about 13 us at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLanes = 32;  // keep equal to core/ingest.py _MAX_LANES

struct Lanes {
  const unsigned char* ptr[kMaxLanes];  // [K*R] lane of `size` bytes an element
  int size[kMaxLanes];
  int off[kMaxLanes];  // byte offset of the lane in a packed row
  int n;
};

// Inclusive scan of one int per thread over the block (Hillis-Steele in
// shared memory); *total gets the block's sum. Every thread must call it.
__device__ int block_inclusive(int x, int* total) {
  __shared__ int buf[2][kThreads];
  const int t = threadIdx.x;
  int cur = 0;
  buf[cur][t] = x;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    int v = buf[cur][t];
    if (t >= d) v += buf[cur][t - d];
    buf[cur ^ 1][t] = v;
    cur ^= 1;
    __syncthreads();
  }
  const int r = buf[cur][t];
  *total = buf[cur][kThreads - 1];
  __syncthreads();  // buf is reused by the caller's next call
  return r;
}

__global__ void count_kernel(const bool* dv, int R, int T, int* tile_counts) {
  const int t = blockIdx.x, k = blockIdx.y;
  const int i = t * kThreads + threadIdx.x;
  const int x = (i < R && dv[(long long)k * R + i]) ? 1 : 0;
  int total;
  block_inclusive(x, &total);
  if (threadIdx.x == 0) tile_counts[k * T + t] = total;
}

__global__ void scan_kernel(const int* tile_counts, int K, int T, int W, int hdr_rows,
                            int* tile_off, int* total, unsigned char* out) {
  const int n = K * T;
  int carry = 0;
  for (int i0 = 0; i0 < n; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const int x = i < n ? tile_counts[i] : 0;
    int tot;
    const int incl = block_inclusive(x, &tot);
    if (i < n) tile_off[i] = carry + incl - x;
    carry += tot;
  }
  if (threadIdx.x == 0) *total = carry;
  // header: the per-micro-batch counts, then zeros up to hdr_rows * W bytes
  const long long hdr_bytes = (long long)hdr_rows * W;
  for (long long b = threadIdx.x; b < hdr_bytes; b += kThreads) {
    unsigned char v = 0;
    if (b < 4LL * K) {
      const int k = (int)(b / 4);
      int c = 0;
      for (int t = 0; t < T; ++t) c += tile_counts[k * T + t];
      v = (unsigned char)(((unsigned int)c >> (8 * (b % 4))) & 0xffu);
    }
    out[b] = v;
  }
}

__global__ void scatter_kernel(const bool* dv, int R, int T, Lanes lanes, int W,
                               int hdr_rows, const int* tile_off, const int* total,
                               unsigned char* out) {
  const int t = blockIdx.x, k = blockIdx.y;
  const int i = t * kThreads + threadIdx.x;
  const long long p = (long long)k * R + i;  // flat position = arrival order
  const int keep = (i < R && dv[p]) ? 1 : 0;
  int tot;
  const int incl = block_inclusive(keep, &tot);
  unsigned char* rows = out + (long long)hdr_rows * W;
  if (keep) {
    unsigned char* dst = rows + (long long)(tile_off[k * T + t] + incl - 1) * W;
    for (int l = 0; l < lanes.n; ++l) {
      const int sz = lanes.size[l];
      const unsigned char* src = lanes.ptr[l] + p * sz;
      for (int b = 0; b < sz; ++b) dst[lanes.off[l] + b] = src[b];
    }
  }
  if (i < R && p >= *total) {
    unsigned char* dst = rows + p * W;
    for (int b = 0; b < W; ++b) dst[b] = 0;
  }
}

}  // namespace

extern "C" {

// lane_ptrs / lane_sizes / lane_offs: host arrays of n_lanes entries, in the
// packed row's lane order. tile_counts / tile_off: scratch of K * ceil(R /
// 1024) ints; total: one int (the kept row count, left on the card).
int deliver_pack(const bool* dv, int K, int R, int n_lanes, const void* const* lane_ptrs,
                 const int* lane_sizes, const int* lane_offs, int W, int hdr_rows,
                 int* tile_counts, int* tile_off, int* total, unsigned char* out,
                 cudaStream_t stream) {
  if (n_lanes < 1 || n_lanes > kMaxLanes || K < 1 || R < 1 || K >= 65536)
    return (int)cudaErrorInvalidValue;
  Lanes lanes;
  lanes.n = n_lanes;
  for (int l = 0; l < kMaxLanes; ++l) {
    lanes.ptr[l] = l < n_lanes ? static_cast<const unsigned char*>(lane_ptrs[l]) : nullptr;
    lanes.size[l] = l < n_lanes ? lane_sizes[l] : 0;
    lanes.off[l] = l < n_lanes ? lane_offs[l] : 0;
  }
  const int T = (R + kThreads - 1) / kThreads;
  count_kernel<<<dim3(T, K), kThreads, 0, stream>>>(dv, R, T, tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, kThreads, 0, stream>>>(tile_counts, K, T, W, hdr_rows, tile_off, total,
                                          out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scatter_kernel<<<dim3(T, K), kThreads, 0, stream>>>(dv, R, T, lanes, W, hdr_rows,
                                                      tile_off, total, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
