// K49: the key-sharded group-by's owner hash and its owner-masked fold.
//
// Replaces siddhi_tpu/parallel/keyshard.py:62 `mix64` and :74 `owner_of`
// (the splitmix64 finalizer over each group key's uint64 bits, then % D:
// the key's owning mesh device) and the fold of
// `KeyShardedGroupExec._step_impl` (:227-251): each output lane takes its
// owner device's value, a psum over devices of owner-masked lanes (floats
// bitcast to integer bits first so -0.0 and NaN payloads survive, bools
// folded as int32 > 0), and `valid` is the OR over devices.
//
// ks_owner: one thread a row, splitmix64 with wrapping 64-bit multiplies and
// logical shifts, then an unsigned % D; bit-identical to the numpy form.
// ks_fold: one thread a (row, lane) over the [D, B] stacked shard lanes on
// one device. Given the owners, the masked psum is a copy of the owner's
// bits (every other device contributes zero), so each thread copies one
// element of 1, 2, 4 or 8 bytes; the last lane index is `valid`'s OR.
//
// Bound: bytes (the D x B x lanes read, B x lanes written; no arithmetic to
// speak of).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kM1 = 0xBF58476D1CE4E5B9ull;
constexpr unsigned long long kM2 = 0x94D049BB133111EBull;
constexpr int kMaxLanes = 32;
constexpr int kThreads = 256;

struct FoldLanes {
  const void* in[kMaxLanes];  // [D, B] stacked, contiguous
  void* out[kMaxLanes];       // [B]
  int size[kMaxLanes];        // bytes an element: 1, 2, 4 or 8
};

__global__ void owner_kernel(const long long* keys, int n, unsigned long long d, int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned long long k = static_cast<unsigned long long>(keys[i]);
  k ^= k >> 30;
  k *= kM1;
  k ^= k >> 27;
  k *= kM2;
  k ^= k >> 31;
  out[i] = static_cast<int>(k % d);
}

template <typename T>
__device__ __forceinline__ void copy_elem(const void* in, void* out, long long src, int dst,
                                          bool zero) {
  static_cast<T*>(out)[dst] = zero ? T(0) : static_cast<const T*>(in)[src];
}

__global__ void fold_kernel(FoldLanes L, int nl, int D, int B, const int* owner,
                            const bool* valid, bool* valid_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (b >= B) return;
  if (c == nl) {  // valid: the OR over devices
    bool v = false;
    for (int d = 0; d < D; ++d) v |= valid[static_cast<long long>(d) * B + b];
    valid_out[b] = v;
    return;
  }
  const int o = owner[b];
  const bool zero = o < 0 || o >= D;  // no owner: every masked lane is zero
  const long long src = static_cast<long long>(zero ? 0 : o) * B + b;
  switch (L.size[c]) {
    case 1: copy_elem<uint8_t>(L.in[c], L.out[c], src, b, zero); break;
    case 2: copy_elem<uint16_t>(L.in[c], L.out[c], src, b, zero); break;
    case 4: copy_elem<uint32_t>(L.in[c], L.out[c], src, b, zero); break;
    default: copy_elem<unsigned long long>(L.in[c], L.out[c], src, b, zero); break;
  }
}

}  // namespace

extern "C" int ks_owner(const void* keys, int n, int d, void* out, void* stream) {
  if (n < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  owner_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, n, (unsigned long long)d, (int*)out);
  return (int)cudaGetLastError();
}

// ins, outs, sizes: host arrays of nl entries.
extern "C" int ks_fold(int nl, int D, int B, const void* const* ins, void* const* outs,
                       const int* sizes, const void* owner, const void* valid, void* valid_out,
                       void* stream) {
  if (nl < 0 || nl > kMaxLanes || D < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  FoldLanes L{};
  for (int c = 0; c < nl; ++c) {
    if (sizes[c] != 1 && sizes[c] != 2 && sizes[c] != 4 && sizes[c] != 8)
      return (int)cudaErrorInvalidValue;
    L.in[c] = ins[c];
    L.out[c] = outs[c];
    L.size[c] = sizes[c];
  }
  const dim3 grid((B + kThreads - 1) / kThreads, nl + 1);
  fold_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      L, nl, D, B, (const int*)owner, (const bool*)valid, (bool*)valid_out);
  return (int)cudaGetLastError();
}
