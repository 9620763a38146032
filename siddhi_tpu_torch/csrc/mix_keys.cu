// K47: composite group keys — splitmix64 rounds over up to eight key
// columns into one int64 key.
//
// Replaces siddhi_tpu/ops/group.py:37 `mix_keys` (the XLA-compiled
// elementwise int64 ops every composite `group by`, a partitioned group's
// (partition slot, key), an aggregation's row key and the frequent windows'
// key lane run through). Bit for bit as the JAX package: each column widened
// to int64 (int32 and interned ids sign-extended, bool 0/1, a float32 by its
// int32 bits, as the callers' `_as_key_col` hands floats over), then
// h = (h ^ c) * MIX1; h = (h ^ (h >> 29)) * MIX2 with a wrapping multiply and
// an ARITHMETIC (signed) shift, not splitmix64's logical one.
//
// Bound: bytes (each column read once, the key written once; a few integer
// operations a byte). Design: one thread a row, the columns' pointers and
// type codes in the kernel's parameters, one pass: the stock torch form
// writes and reads an int64 temporary four times a column.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCols = 8;
constexpr unsigned long long kMix1 = 0x9E3779B97F4A7C15ull;
constexpr unsigned long long kMix2 = 0xBF58476D1CE4E5B9ull;

struct KeyCols {
  const void* col[kMaxCols];
  int code[kMaxCols];  // 0 int32, 1 int64, 2 bool, 3 float32 (its bits)
};

__device__ __forceinline__ long long widen(const void* p, int code, int i) {
  switch (code) {
    case 1: return static_cast<const long long*>(p)[i];
    case 2: return static_cast<const bool*>(p)[i] ? 1 : 0;
    default: return static_cast<const int32_t*>(p)[i];  // int32, or a float's bits
  }
}

__global__ void mix_kernel(KeyCols c, int ncols, int n, long long* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned long long h = 0;
  for (int k = 0; k < ncols; ++k) {
    h = (h ^ static_cast<unsigned long long>(widen(c.col[k], c.code[k], i))) * kMix1;
    const long long shifted = static_cast<long long>(h) >> 29;  // arithmetic
    h = (h ^ static_cast<unsigned long long>(shifted)) * kMix2;
  }
  out[i] = static_cast<long long>(h);
}

}  // namespace

extern "C" int mk_mix(int n, int ncols, const void* c0, const void* c1, const void* c2,
                      const void* c3, const void* c4, const void* c5, const void* c6,
                      const void* c7, int k0, int k1, int k2, int k3, int k4, int k5, int k6,
                      int k7, void* out, void* stream) {
  if (ncols < 1 || ncols > kMaxCols || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  KeyCols c{{c0, c1, c2, c3, c4, c5, c6, c7}, {k0, k1, k2, k3, k4, k5, k6, k7}};
  constexpr int threads = 256;
  mix_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      c, ncols, n, (long long*)out);
  return (int)cudaGetLastError();
}
