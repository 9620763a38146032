// Batch-mode collapse: the last valid row of each (segment id, kind bit),
// for Hopper (sm_90a).
//
// Replaces siddhi_tpu/ops/group.py keep_last_in_sorted (:278-305, the
// grouped collapse: a reverse segmented max per kind lane over the sorted
// view, then back to row order) and keep_last_per_group (:308-334, the
// ungrouped one: a lax.sort by the flush-chunk id and a reverse segmented
// max). Both are: out[i] = valid[i] and i is the largest valid row with i's
// (id, kind bit). Here that is one atomicMax of the row index into a scratch
// lane indexed by id*2 + kind bit, then one compare per row; the result is
// exact whatever order the atomics land in.
// What bounds it on the card: bytes (rows x 6 B in, rows x 1 B out, plus
// the scratch lane), well under a microsecond at 3.35 TB/s; the launches
// (a memset and two kernels) dominate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void mark_kernel(const int32_t* ids, const bool* kbit, const bool* valid,
                            int rows, int32_t* last) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows && valid[i]) atomicMax(&last[2 * ids[i] + (kbit[i] ? 1 : 0)], i);
}

__global__ void check_kernel(const int32_t* ids, const bool* kbit, const bool* valid,
                             int rows, const int32_t* last, bool* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < rows) out[i] = valid[i] && last[2 * ids[i] + (kbit[i] ? 1 : 0)] == i;
}

}  // namespace

extern "C" {

// ids in [0, rows]; scratch holds 2 (rows + 1) int32.
int keep_last(const int32_t* ids, const bool* kbit, const bool* valid, int rows,
              int32_t* scratch, bool* out, cudaStream_t stream) {
  cudaError_t err =
      cudaMemsetAsync(scratch, 0xff, sizeof(int32_t) * 2 * ((size_t)rows + 1), stream);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + kThreads - 1) / kThreads;
  mark_kernel<<<blocks, kThreads, 0, stream>>>(ids, kbit, valid, rows, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  check_kernel<<<blocks, kThreads, 0, stream>>>(ids, kbit, valid, rows, scratch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
