// K50: the routed pre-pass of a sharded partitioned query.
//
// Replaces the pre-pass of siddhi_tpu/parallel/mesh.py:175
// `_make_routed_step.routed_step` (:200-222): each active row goes to
// device slot % D (slot < P; slots stripe across devices), TIMER rows to
// every device; each device's rows keep their row order, ranked by a cumsum
// over a [D, B] mask and scattered into [D, B] routed row indices (B marks
// a pad); then every lane is gathered through the routed indices with JAX's
// fills: 0 for ts, kind and the columns, P for the slot lane, and
// `valid` = not a pad.
//
// sr_route: one block a device. The block walks B in tiles of kThreads
// rows, an exclusive block scan of take(d, b) ranks each tile's rows after
// the carry of the tiles before, routed[d, rank] = b, and the tail of the
// device's row is filled with B. sr_gather: one thread a (routed lane
// element, lane), a copy of 1, 2, 4 or 8 bytes or its zero fill; the last
// lane index writes the routed slot and valid lanes. All integer: exact.
//
// Bound: bytes (the [B] slot, active and timer masks and every input lane
// read once, the [D, B] routed indices and lanes written once).

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kGatherThreads = 256;
constexpr int kMaxLanes = 32;

struct RouteLanes {
  const void* in[kMaxLanes];  // [B]
  void* out[kMaxLanes];       // [D, B]
  int size[kMaxLanes];
};

__global__ void route_kernel(int B, int D, int P, const int32_t* slot, const bool* active,
                            const bool* is_timer, int32_t* routed) {
  __shared__ int ws[32];
  const int d = blockIdx.x;
  int32_t* row = routed + static_cast<long long>(d) * B;
  int carry = 0;
  for (int base = 0; base < B; base += kThreads) {
    const int b = base + threadIdx.x;
    int take = 0;
    if (b < B) {
      const int s = slot[b];
      take = (active[b] && s >= 0 && s < P && s % D == d) || is_timer[b];
    }
    int total;
    const int excl = block_excl_sum(take, ws, &total);
    if (take) row[carry + excl] = b;
    carry += total;
  }
  for (int j = carry + threadIdx.x; j < B; j += kThreads) row[j] = B;
}

template <typename T>
__device__ __forceinline__ void gather_elem(const void* in, void* out, int r, long long j,
                                            bool pad) {
  static_cast<T*>(out)[j] = pad ? T(0) : static_cast<const T*>(in)[r];
}

__global__ void gather_kernel(RouteLanes L, int nl, int B, int D, int P, const int32_t* routed,
                              const int32_t* slot, const bool* active, int32_t* rslot,
                              bool* rvalid) {
  const long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int c = blockIdx.y;
  if (j >= static_cast<long long>(D) * B) return;
  const int r = routed[j];
  const bool pad = r >= B;
  if (c == nl) {
    rslot[j] = pad ? P : (active[r] ? slot[r] : P);
    rvalid[j] = !pad;
    return;
  }
  switch (L.size[c]) {
    case 1: gather_elem<uint8_t>(L.in[c], L.out[c], r, j, pad); break;
    case 2: gather_elem<uint16_t>(L.in[c], L.out[c], r, j, pad); break;
    case 4: gather_elem<uint32_t>(L.in[c], L.out[c], r, j, pad); break;
    default: gather_elem<unsigned long long>(L.in[c], L.out[c], r, j, pad); break;
  }
}

}  // namespace

// ins, outs, sizes: host arrays of nl lane entries; routed, rslot: [D, B]
// int32; rvalid: [D, B] bool.
extern "C" int sr_route(int B, int D, int P, const void* slot, const void* active,
                        const void* is_timer, int nl, const void* const* ins,
                        void* const* outs, const int* sizes, void* routed, void* rslot,
                        void* rvalid, void* stream) {
  if (B < 0 || D < 1 || P < 0 || nl < 0 || nl > kMaxLanes) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  RouteLanes L{};
  for (int c = 0; c < nl; ++c) {
    if (sizes[c] != 1 && sizes[c] != 2 && sizes[c] != 4 && sizes[c] != 8)
      return (int)cudaErrorInvalidValue;
    L.in[c] = ins[c];
    L.out[c] = outs[c];
    L.size[c] = sizes[c];
  }
  cudaStream_t st = (cudaStream_t)stream;
  route_kernel<<<D, kThreads, 0, st>>>(B, D, P, (const int32_t*)slot, (const bool*)active,
                                       (const bool*)is_timer, (int32_t*)routed);
  const long long n = static_cast<long long>(D) * B;
  const dim3 grid(static_cast<unsigned>((n + kGatherThreads - 1) / kGatherThreads), nl + 1);
  gather_kernel<<<grid, kGatherThreads, 0, st>>>(L, nl, B, D, P, (const int32_t*)routed,
                                                 (const int32_t*)slot, (const bool*)active,
                                                 (int32_t*)rslot, (bool*)rvalid);
  return (int)cudaGetLastError();
}
