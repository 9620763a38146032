// Completions of the pattern engine for Hopper (sm_90a): the tokens that
// passed the last NFA slot in a chunk go into the emission buffer, ordered
// by completion row then lane, and leave the token table; on the fast
// route, tokens whose `within` expired are purged.
//
// Replaces siddhi_tpu/core/pattern.py PatternProgram.apply_batch_fast
// :1864-1912 and apply_batch_count :1687-1725: done = active & slot == S,
// the argsort of key = entry_row * T + lane, the cumsum rank of the done
// tokens in that order, the capped scatter into out_n + rank (the overflow
// flag past the capacity), the gathers of every ref's count, captured
// timestamps and kept columns, the emit timestamp (the completion row's, or
// `now` without one), out_n += done (capped), active &= ~done, and the
// per-slot `within` purge that keeps the arming token.
// Design: one block. A block scan lists the done tokens in lane order; each
// takes as its rank the number of done tokens with a smaller key (the keys
// are unique, so this is JAX's argsort order exactly; D done tokens cost
// D^2 compares through shared-memory tiles). out_n stays on the device: the
// block reads it, and a second launch copies the emitted rows of every
// lane (the base and the count come from the first launch's scratch).
// What bounds it on the card: bytes, the [T] token lanes read once and the
// emitted rows written once (a few KB a chunk on the pattern paths); one
// block and two launches dominate.

#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;
constexpr int kMaxEmitLanes = 16;

struct EmitLanes {
  const void* src[kMaxEmitLanes];  // [T, width] token-table lane
  void* dst[kMaxEmitLanes];        // [cap, width] emission-buffer lane
  int size[kMaxEmitLanes];
  int width[kMaxEmitLanes];
  int n;
};

__global__ void __launch_bounds__(kBlock, 1)
emit_kernel(const bool* active, const int32_t* slot, const int64_t* start_ts,
            const int32_t* entry_row, int T, int S, const int64_t* batch_ts, const bool* v, int C,
            const int64_t* now, int64_t* out_ts, bool* out_valid, int cap, int32_t* out_n,
            const bool* ovf_in, bool* ovf_o, bool* active_o, int purge,
            const int64_t* win_by_slot, int armer, int32_t* dlist, int32_t* emit_src,
            int32_t* meta) {
  __shared__ int ws[32];
  __shared__ long long keys[kBlock];
  __shared__ long long warp_max[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base_n = *out_n;
  const int room = cap - base_n;

  // the last valid row's timestamp (the purge clock): max(where(v, ts, 0))
  long long last = 0;
  if (purge) {
    for (int j = tid; j < C; j += kBlock)
      if (v[j] && batch_ts[j] > last) last = batch_ts[j];
    for (int d = 16; d > 0; d >>= 1) {
      const long long y = __shfl_down_sync(kFull, last, d);
      last = y > last ? y : last;
    }
    if (lane == 0) warp_max[warp] = last;
    __syncthreads();
    last = 0;
    for (int w = 0; w < (kBlock >> 5); ++w) last = warp_max[w] > last ? warp_max[w] : last;
  }

  // 1. the done tokens, in lane order
  int D = 0;
  for (int base = 0; base < T; base += kBlock) {
    const int t = base + tid;
    const bool done = t < T && active[t] && slot[t] == S;
    int total;
    const int x = block_excl_sum(done, ws, &total);
    if (done) dlist[D + x] = t;
    D += total;
  }
  __syncthreads();

  // 2. rank = the done tokens with a smaller key; the emitted rows' ts/valid
  for (int i0 = 0; i0 < D; i0 += kBlock) {
    const int i = i0 + tid;
    int ti = -1;
    long long ki = 0;
    if (i < D) {
      ti = dlist[i];
      ki = (long long)entry_row[ti] * T + ti;
    }
    int rank = 0;
    for (int k0 = 0; k0 < D; k0 += kBlock) {
      __syncthreads();
      if (k0 + tid < D) {
        const int tk = dlist[k0 + tid];
        keys[tid] = (long long)entry_row[tk] * T + tk;
      }
      __syncthreads();
      const int n = D - k0 < kBlock ? D - k0 : kBlock;
      if (i < D)
        for (int q = 0; q < n; ++q) rank += keys[q] < ki;
    }
    if (i < D && rank < room) {
      const int er = entry_row[ti];
      out_ts[base_n + rank] = er >= 0 ? batch_ts[er] : *now;
      out_valid[base_n + rank] = true;
      emit_src[rank] = ti;
    }
  }

  // 3. done tokens leave the table; expired ones are purged (not the armer)
  for (int t = tid; t < T; t += kBlock) {
    const int s = slot[t];
    bool a = active[t] && s != S;
    if (purge && a) {
      const long long st = start_ts[t];
      const int sc = s < 0 ? 0 : s > S ? S : s;
      const bool expired = st >= 0 && last - st > win_by_slot[sc];
      if (expired && !(armer && t == 0)) a = false;
    }
    active_o[t] = a;
  }
  __syncthreads();
  if (tid == 0) {
    const int emitted = D < room ? D : room;
    meta[0] = base_n;
    meta[1] = emitted;
    *out_n = base_n + emitted;
    *ovf_o = *ovf_in || D > room;
  }
}

template <typename E>
__device__ __forceinline__ void copy_elem(const EmitLanes& L, int l, long long s, long long d) {
  ((E*)L.dst[l])[d] = ((const E*)L.src[l])[s];
}

__global__ void rows_kernel(EmitLanes L, const int32_t* emit_src, const int32_t* meta) {
  const int l = blockIdx.y;
  const int w = L.width[l];
  const int base = meta[0];
  const long long n = (long long)meta[1] * w;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / w, q = i % w;
    const long long s = (long long)emit_src[r] * w + q, d = (base + r) * w + q;
    switch (L.size[l]) {
      case 1: copy_elem<uint8_t>(L, l, s, d); break;
      case 4: copy_elem<uint32_t>(L, l, s, d); break;
      default: copy_elem<unsigned long long>(L, l, s, d); break;
    }
  }
}

}  // namespace

extern "C" {

// One chunk's completions. In place: out_ts/out_valid and the n_lanes
// emission lanes (dst [cap, width], gathered from the token lanes src
// [T, width]), out_n (0-d int32). Fresh: active_o [T], ovf_o = ovf_in |
// (the buffer overflowed). scratch: int32 [2T + 2].
int pe_emit(const bool* active, const int32_t* slot, const int64_t* start_ts,
            const int32_t* entry_row, int T, int S, const int64_t* batch_ts, const bool* v, int C,
            const int64_t* now, int64_t* out_ts, bool* out_valid, int cap, int32_t* out_n,
            const bool* ovf_in, bool* ovf_o, bool* active_o, int purge,
            const int64_t* win_by_slot, int armer, int32_t* scratch, int n_lanes,
            const void* const* src, void* const* dst, const int* size, const int* width,
            cudaStream_t stream) {
  int32_t* dlist = scratch;
  int32_t* emit_src = scratch + T;
  int32_t* meta = scratch + 2 * T;
  emit_kernel<<<1, kBlock, 0, stream>>>(active, slot, start_ts, entry_row, T, S, batch_ts, v, C,
                                        now, out_ts, out_valid, cap, out_n, ovf_in, ovf_o,
                                        active_o, purge, win_by_slot, armer, dlist, emit_src,
                                        meta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int base = 0; base < n_lanes; base += kMaxEmitLanes) {
    EmitLanes L;
    L.n = n_lanes - base < kMaxEmitLanes ? n_lanes - base : kMaxEmitLanes;
    int wmax = 1;
    for (int k = 0; k < L.n; ++k) {
      L.src[k] = src[base + k];
      L.dst[k] = dst[base + k];
      L.size[k] = size[base + k];
      L.width[k] = width[base + k];
      wmax = L.width[k] > wmax ? L.width[k] : wmax;
    }
    long long elems = (long long)T * wmax;
    int blocks = (int)((elems + 255) / 256);
    blocks = blocks > 1024 ? 1024 : blocks < 1 ? 1 : blocks;
    rows_kernel<<<dim3(blocks, L.n), 256, 0, stream>>>(L, emit_src, meta);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
