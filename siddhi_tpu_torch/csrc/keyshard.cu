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
// ks_fold: given the owners, the masked psum is a copy of the owner's bits
// (every other device contributes zero). The D shards' lanes are read in
// place, through a [lanes + 1, D] table of pointers (the last row: each
// shard's `valid`): passed by value as a __grid_constant__ parameter up to
// kTableByValue pointers, past it from a device buffer the wrapper fills.
// A thread a (row, lane) copies the owner's 1, 2, 4 or 8 bytes of its lane
// (the last lane: ORs `valid` over the shards): no [D, B] stack is built,
// and a call is one launch whatever the lanes.
//
// Bound: bytes (the owner and D valid flags a row, one element a lane read,
// B x lanes written; no arithmetic to speak of).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kM1 = 0xBF58476D1CE4E5B9ull;
constexpr unsigned long long kM2 = 0x94D049BB133111EBull;
constexpr int kMaxLanes = 32;
constexpr int kThreads = 256;
// pointers of the [lanes + 1, D] table that travel by value (3 KB of the
// 4 KB of kernel parameters)
constexpr int kTableByValue = 384;

struct FoldOut {
  void* out[kMaxLanes];  // [B]
  int size[kMaxLanes];   // bytes an element: 1, 2, 4 or 8
};

struct FoldTable {
  const void* p[kTableByValue];  // p[c * D + d]: lane c of shard d; row nl: valid
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

// one element of `size` bytes, zero-extended
__device__ __forceinline__ unsigned long long load_elem(const void* in, int b, int size) {
  switch (size) {
    case 1: return static_cast<const uint8_t*>(in)[b];
    case 2: return static_cast<const uint16_t*>(in)[b];
    case 4: return static_cast<const uint32_t*>(in)[b];
    default: return static_cast<const unsigned long long*>(in)[b];
  }
}

__device__ __forceinline__ void store_elem(void* out, int b, int size, unsigned long long v) {
  switch (size) {
    case 1: static_cast<uint8_t*>(out)[b] = (uint8_t)v; break;
    case 2: static_cast<uint16_t*>(out)[b] = (uint16_t)v; break;
    case 4: static_cast<uint32_t*>(out)[b] = (uint32_t)v; break;
    default: static_cast<unsigned long long*>(out)[b] = v; break;
  }
}

// Grid (rows / kThreads, lanes + 1): block row c copies lane c of the
// owners' shards (its D table pointers into shared memory first, since each
// thread indexes them by its own owner, which a constant-bank read would
// serialize across a warp); block row `lanes` ORs `valid` over the shards.
// A thread a (row, lane) rather than a row: measured on the H100, the
// device time of SH-KEYS' fold (B=32,768, D=8, 5 lanes) was 0.0032 ms
// against 0.0052 with one thread a row walking its lanes.
__global__ void __launch_bounds__(kThreads)
fold_kernel(const __grid_constant__ FoldOut O, const __grid_constant__ FoldTable T,
            const void* const* table_g, int nl, int D, int B, const int* owner,
            bool* valid_out) {
  extern __shared__ const void* s_row[];  // [D]: lane c of each shard
  const int c = blockIdx.y;
  const void* const* src = (table_g != nullptr ? table_g : T.p) + (size_t)c * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) s_row[d] = src[d];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  if (c == nl) {  // valid: the OR over devices
    bool any = false;
    for (int d = 0; d < D; ++d) any |= static_cast<const bool*>(s_row[d])[b];
    valid_out[b] = any;
    return;
  }
  const int o = owner[b];
  const bool none = o < 0 || o >= D;  // no owner: every masked lane is zero
  store_elem(O.out[c], b, O.size[c], none ? 0ull : load_elem(s_row[o], b, O.size[c]));
}

}  // namespace

extern "C" int ks_owner(const void* keys, int n, int d, void* out, void* stream) {
  if (n < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  owner_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)keys, n, (unsigned long long)d, (int*)out);
  return (int)cudaGetLastError();
}

// args: a host array of nl out pointers, nl element sizes, then the
// [nl + 1, D] table (lane c of shard d at nl + nl + c * D + d; row nl each
// shard's valid). table_g: the same table on the device when it holds more
// than kTableByValue pointers, else null.
extern "C" int ks_fold(int nl, int D, int B, const long long* args, const void* owner,
                       void* valid_out, const void* table_g, void* stream) {
  if (nl < 0 || nl > kMaxLanes || D < 1 || B < 0) return (int)cudaErrorInvalidValue;
  const int entries = (nl + 1) * D;
  if (entries > kTableByValue && table_g == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  FoldOut O{};
  for (int c = 0; c < nl; ++c) {
    const int size = (int)args[nl + c];
    if (size != 1 && size != 2 && size != 4 && size != 8) return (int)cudaErrorInvalidValue;
    O.out[c] = (void*)args[c];
    O.size[c] = size;
  }
  FoldTable T{};
  if (table_g == nullptr)
    for (int e = 0; e < entries; ++e) T.p[e] = (const void*)args[2 * nl + e];
  if ((size_t)D * sizeof(void*) > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kThreads - 1) / kThreads, nl + 1);
  fold_kernel<<<grid, kThreads, (size_t)D * sizeof(void*), (cudaStream_t)stream>>>(
      O, T, (const void* const*)table_g, nl, D, B, (const int*)owner, (bool*)valid_out);
  return (int)cudaGetLastError();
}
