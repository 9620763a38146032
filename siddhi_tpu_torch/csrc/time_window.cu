// Sliding time-window step (time, timeLength, externalTime): B arrivals into
// a W-slot ring, for Hopper (sm_90a).
//
// Replaces siddhi_tpu/core/windows.py SlidingWindow.apply's time path
// (:190-326) with _ring_state (:329) and _place_ring (:458). The JAX step
// builds a [W+B, B] "due" matrix (element e expires at row r) to find each
// element's first trigger row, lexsorts W+2B death/birth candidates on
// (trigger row * 2 | row * 2 + 1, seq), and builds a [W+2B, W+B] membership
// matrix: 1.1 G and 2.25 G booleans at B = 32768. Here neither is formed:
//   - trigger row: the first CURRENT/TIMER row r >= the element's own row
//     whose window time is >= its own + t is a "first index >= s with value
//     >= x" query on a max segment tree over the B rows (O(log B) per
//     element); the capacity trigger is the rank arithmetic of the length
//     step (the insertion of seq + W evicts seq). The earlier of the two wins.
//   - order: a live ring seq lies in [total - W, total) and a batch seq in
//     [total, total + c), so seq is a dense index and (trigger row, seq)
//     order is a stable counting sort by trigger row over seq order. A
//     death's output position is (births before its trigger row) + (deaths
//     ordered before it); a birth's is (births before its row) + (deaths
//     triggered at or before its row). Deaths per trigger row are a
//     histogram and one scan. Two algorithm branches give "deaths ordered
//     before": when the trigger row never decreases in seq (time windows,
//     ordered externalTime) it is one exclusive scan in seq order; otherwise
//     (disordered externalTime) a stable counting sort: 1024-element tiles
//     of the seq order, each sorted on (trigger row, position) in shared
//     memory, with per-row cursors carried from tile to tile. The block
//     detects which branch holds on the device; the host never syncs.
//   - membership stays lazy: birth_pos/death_pos [W+B] int32 lanes, the
//     contract the windowed min/max kernel reads.
//   - ring update: slot j takes the insertion rho in [max(0, c-W), c) with
//     (total + rho) % W == j unless that row expired within the batch, else
//     it is cleared if its element expired, else kept (holes stay holes).
// The lanes are then filled by the length step's gather (lw_gather_N of
// length_window.cu) from out_src / ring_src.
// What bounds it on the card: bytes (each lane read once, W+2B rows and the
// new ring written once: ~2 MB at B = 32768, a microsecond at 3.35 TB/s);
// at these sizes the three single-block passes and the launches dominate.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;  // threads of the single-block passes
constexpr int kItems = 32;    // rows per thread in the CURRENT-rank scan
constexpr int kThreads = 256;
constexpr long long kNoTimer = LLONG_MAX;

__device__ __forceinline__ bool is_current(const int8_t* kind, const bool* valid, int r) {
  return valid[r] && kind[r] == 0;
}

// Inclusive block-wide max.
__device__ int block_incl_max(int v, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl = max(incl, y);
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int x = ws[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = max(x, y);
    }
    ws[lane] = x;
  }
  __syncthreads();
  const int out = warp > 0 ? max(incl, ws[warp - 1]) : incl;
  __syncthreads();
  return out;
}

// rank[r] = valid-CURRENT rows before r (every row), perm[rank] = r, count;
// the max segment tree over trigger rows (leaves [P, 2P)); zeroed histogram
// and cursors; by_seq cleared.
__global__ void __launch_bounds__(kBlock, 1)
scan_kernel(const int8_t* kind, const bool* valid, const int64_t* bwts, int B, int W,
            int P, int64_t* tree, int32_t* rank, int32_t* perm, int32_t* count,
            int32_t* hist, int32_t* cursor, int32_t* by_seq) {
  __shared__ int ws[32];
  __shared__ int tile_total;
  const int tid = threadIdx.x;
  int carry = 0;
  for (int base = 0; base < B; base += kBlock * kItems) {
    const int start = base + tid * kItems;
    unsigned flags = 0;
    int local = 0;
    for (int k = 0; k < kItems; ++k) {
      const int r = start + k;
      const bool vc = r < B && is_current(kind, valid, r);
      flags |= (unsigned)vc << k;
      local += vc;
    }
    int excl = carry + block_excl_sum(local, ws, &tile_total);
    for (int k = 0; k < kItems; ++k) {
      const int r = start + k;
      if (r >= B) break;
      rank[r] = excl;
      if ((flags >> k) & 1u) perm[excl++] = r;
    }
    carry += tile_total;
  }
  if (tid == 0) *count = carry;
  for (int r = tid; r < P; r += kBlock) {
    const bool trig = r < B && valid[r] && (kind[r] == 0 || kind[r] == 2);
    tree[P + r] = trig ? bwts[r] : LLONG_MIN;
    if (r < B) {
      hist[r] = 0;
      cursor[r] = 0;
    }
  }
  for (int i = tid; i < W + B; i += kBlock) by_seq[i] = -1;
  __syncthreads();
  for (int half = P >> 1; half >= 1; half >>= 1) {
    for (int i = half + tid; i < 2 * half; i += kBlock) {
      const long long a = tree[2 * i], b = tree[2 * i + 1];
      tree[i] = a > b ? a : b;
    }
    __syncthreads();
  }
}

// First leaf index >= s whose value is >= x, or -1.
__device__ int first_at_least(const int64_t* tree, int P, int s, long long x) {
  int i = s + P;
  if (tree[i] >= x) return s;
  for (;;) {
    while (i & 1) {
      if (i == 1) return -1;
      i >>= 1;
    }
    ++i;
    if (tree[i] >= x) {
      while (i < P) i = tree[2 * i] >= x ? 2 * i : 2 * i + 1;
      return i - P;
    }
  }
}

// Per element e of [ring slots | batch rows]: its trigger row (INT_MAX: none
// this batch, -1: absent), the histogram of trigger rows, and its entry in
// seq order.
__global__ void elem_kernel(const int8_t* kind, const bool* valid, const int64_t* bwts,
                            const int64_t* ring_seq, const int64_t* ring_wts,
                            const int64_t* total, const int32_t* count, const int32_t* rank,
                            const int32_t* perm, const int64_t* tree, int B, int W, int P,
                            long long t, int32_t* trig, int32_t* hist, int32_t* by_seq) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= W + B) return;
  const long long tot = *total;
  const long long c = *count;
  long long seq, wts;
  int start;
  bool present;
  if (e < W) {
    seq = ring_seq[e];
    present = seq >= 0;
    wts = ring_wts[e];
    start = 0;
  } else {
    const int r = e - W;
    present = is_current(kind, valid, r);
    seq = tot + rank[r];
    wts = bwts[r];
    start = r;
  }
  if (!present) {
    trig[e] = -1;
    return;
  }
  int tr = INT_MAX;
  const long long lr = seq + W - tot;  // the insertion rank that evicts e
  if (lr >= 0 && lr < c) tr = perm[lr];
  const int ft = first_at_least(tree, P, start, wts + t);
  if (ft >= 0 && ft < B && ft < tr) tr = ft;
  trig[e] = tr;
  if (tr != INT_MAX) atomicAdd(&hist[tr], 1);
  const long long idx = seq - (tot - W);
  if (idx >= 0 && idx < (long long)W + B) by_seq[idx] = e;
}

// dx[r] = deaths triggered before row r; dpos[e] = deaths ordered before
// death e (by trigger row, then seq); n_valid = c + deaths.
__global__ void __launch_bounds__(kBlock, 1)
order_kernel(const int32_t* count, const int32_t* trig, const int32_t* hist,
             const int32_t* by_seq, int B, int W, int32_t* dx, int32_t* cursor,
             int32_t* dpos, int32_t* n_valid) {
  __shared__ int ws[32];
  __shared__ int tile_total;
  __shared__ int bad;
  __shared__ unsigned long long keys[kBlock];
  __shared__ int elem_of[kBlock];
  const int tid = threadIdx.x;
  int carry = 0;
  for (int base = 0; base < B; base += kBlock) {
    const int r = base + tid;
    const int h = r < B ? hist[r] : 0;
    const int excl = block_excl_sum(h, ws, &tile_total);
    if (r < B) dx[r] = carry + excl;
    carry += tile_total;
  }
  const int n_deaths = carry;
  const int n_seq = W + *count;
  if (tid == 0) bad = 0;
  // branch 1: deaths in seq order, with the check that the trigger row
  // never decreases along it
  carry = 0;
  int run_max = -1;
  for (int base = 0; base < n_seq; base += kBlock) {
    const int idx = base + tid;
    const int e = idx < n_seq ? by_seq[idx] : -1;
    const int tr = e >= 0 ? trig[e] : -1;
    const bool death = tr >= 0 && tr != INT_MAX;
    const int excl = block_excl_sum(death, ws, &tile_total);
    const int mx = block_incl_max(death ? tr : -1, ws);
    if (death) dpos[e] = carry + excl;
    keys[tid] = (unsigned long long)(unsigned)(mx + 1);
    __syncthreads();
    // the largest trigger row of the deaths strictly before this one
    const int prior = max(run_max, tid > 0 ? (int)keys[tid - 1] - 1 : -1);
    if (death && tr < prior) bad = 1;
    const int tile_max = (int)keys[kBlock - 1] - 1;
    __syncthreads();
    carry += tile_total;
    run_max = max(run_max, tile_max);
  }
  __syncthreads();
  if (bad) {
    // branch 2: stable counting sort by trigger row over seq order
    for (int base = 0; base < n_seq; base += kBlock) {
      const int idx = base + tid;
      const int e = idx < n_seq ? by_seq[idx] : -1;
      const int tr = e >= 0 ? trig[e] : -1;
      const bool death = tr >= 0 && tr != INT_MAX;
      keys[tid] = death ? ((unsigned long long)tr << 32) | (unsigned)tid : ~0ull;
      elem_of[tid] = e;
      __syncthreads();
      for (int k = 2; k <= kBlock; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          const int ixj = tid ^ j;
          if (ixj > tid) {
            const unsigned long long a = keys[tid], b = keys[ixj];
            if ((a > b) == ((tid & k) == 0)) {
              keys[tid] = b;
              keys[ixj] = a;
            }
          }
          __syncthreads();
        }
      }
      const unsigned long long key = keys[tid];
      const bool dead = key != ~0ull;
      const int row = (int)(key >> 32);
      const bool head = dead && (tid == 0 || (int)(keys[tid - 1] >> 32) != row);
      const int run_start = block_incl_max(head ? tid : 0, ws);
      const int within = tid - run_start;
      const int seen = dead ? cursor[row] : 0;
      __syncthreads();
      const bool last = dead && (tid == kBlock - 1 || keys[tid + 1] == ~0ull ||
                                 (int)(keys[tid + 1] >> 32) != row);
      if (last) cursor[row] = seen + within + 1;
      if (dead) dpos[elem_of[key & 0xffffffffu]] = dx[row] + seen + within;
      __syncthreads();
    }
  }
  if (tid == 0) *n_valid = *count + n_deaths;
}

// Every output row, the lazy membership lanes and the ring's sources.
__global__ void emit_kernel(const int64_t* batch_ts, const int64_t* ring_seq,
                            const int64_t* total, const int32_t* count,
                            const int32_t* rank, const int32_t* perm, const int32_t* trig,
                            const int32_t* hist, const int32_t* dx, const int32_t* dpos,
                            const int32_t* n_valid, int B, int W, int32_t* birth,
                            int32_t* death, int32_t* out_src, int64_t* out_ts,
                            int8_t* out_kind, bool* out_valid, int32_t* ring_src,
                            int64_t* new_seq, int64_t* new_total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_out = W + 2 * B;
  if (i >= n_out) return;
  const long long tot = *total;
  const int c = *count;
  if (i < W + B) {
    const int e = i;
    const int tr = trig[e];
    if (tr < 0) {
      birth[e] = -1;
      death[e] = -1;
    } else {
      if (e < W) {
        birth[e] = -1;
      } else {
        const int r = e - W;
        const int pb = rank[r] + dx[r] + hist[r];
        birth[e] = pb;
        out_src[pb] = e;
        out_kind[pb] = 0;
        out_ts[pb] = batch_ts[r];
        out_valid[pb] = true;
      }
      if (tr == INT_MAX) {
        death[e] = INT_MAX;
      } else {
        const int pd = rank[tr] + dpos[e];
        death[e] = pd;
        out_src[pd] = e;
        out_kind[pd] = 1;  // EXPIRED, stamped with the trigger row's ts
        out_ts[pd] = batch_ts[tr];
        out_valid[pd] = true;
      }
    }
  }
  if (i >= *n_valid) {
    out_src[i] = -1;
    out_kind[i] = 0;
    out_ts[i] = 0;
    out_valid[i] = false;
  }
  if (i < W) {
    const long long r0 = c > W ? c - W : 0;
    const long long rho = r0 + (((i - tot - r0) % W) + W) % W;
    const int row = rho < c ? perm[rho] : -1;
    const int tr = trig[i];
    if (row >= 0 && trig[W + row] == INT_MAX) {
      ring_src[i] = W + row;
      new_seq[i] = tot + rho;
    } else if (tr >= 0 && tr != INT_MAX) {
      ring_src[i] = -1;
      new_seq[i] = -1;
    } else {
      ring_src[i] = i;
      new_seq[i] = ring_seq[i];
    }
  }
  if (i == 0) *new_total = tot + c;
}

// next_timer = the earliest live window time of the new ring + t.
__global__ void __launch_bounds__(kBlock, 1)
timer_kernel(const int32_t* ring_src, const int64_t* new_seq, const int64_t* ring_wts,
             const int64_t* bwts, int W, long long t, int64_t* next_timer) {
  __shared__ long long part[kBlock];
  const int tid = threadIdx.x;
  long long m = kNoTimer - t;
  for (int i = tid; i < W; i += kBlock) {
    if (new_seq[i] < 0) continue;
    const int s = ring_src[i];
    const long long v = s < W ? ring_wts[s] : bwts[s - W];
    if (v < m) m = v;
  }
  part[tid] = m;
  __syncthreads();
  for (int d = kBlock / 2; d > 0; d >>= 1) {
    if (tid < d && part[tid + d] < part[tid]) part[tid] = part[tid + d];
    __syncthreads();
  }
  if (tid == 0) *next_timer = part[0] + t;
}

}  // namespace

extern "C" {

int tw_prepare(const int8_t* kind, const bool* valid, const int64_t* batch_ts,
               const int64_t* bwts, const int64_t* ring_seq, const int64_t* ring_wts,
               const int64_t* total, int B, int W, int P, long long t, int64_t* tree,
               int32_t* rank, int32_t* perm, int32_t* count, int32_t* trig, int32_t* hist,
               int32_t* dx, int32_t* cursor, int32_t* by_seq, int32_t* dpos,
               int32_t* n_valid, int32_t* birth, int32_t* death, int32_t* out_src,
               int64_t* out_ts, int8_t* out_kind, bool* out_valid, int32_t* ring_src,
               int64_t* new_seq, int64_t* new_total, int64_t* next_timer,
               cudaStream_t stream) {
  scan_kernel<<<1, kBlock, 0, stream>>>(kind, valid, bwts, B, W, P, tree, rank, perm, count,
                                        hist, cursor, by_seq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  elem_kernel<<<(W + B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      kind, valid, bwts, ring_seq, ring_wts, total, count, rank, perm, tree, B, W, P, t,
      trig, hist, by_seq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  order_kernel<<<1, kBlock, 0, stream>>>(count, trig, hist, by_seq, B, W, dx, cursor, dpos,
                                         n_valid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  emit_kernel<<<(W + 2 * B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      batch_ts, ring_seq, total, count, rank, perm, trig, hist, dx, dpos, n_valid, B, W,
      birth, death, out_src, out_ts, out_kind, out_valid, ring_src, new_seq, new_total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  timer_kernel<<<1, kBlock, 0, stream>>>(ring_src, new_seq, ring_wts, bwts, W, t, next_timer);
  return (int)cudaGetLastError();
}

}  // extern "C"
