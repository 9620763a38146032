// Group-slot assignment: a batch's rows against the persistent [G] key
// table, for Hopper (sm_90a).
//
// Replaces siddhi_tpu/ops/group.py assign_slots (:85-191) with its
// compact_set_at table writes (ops/scatter.py:56). The JAX function groups
// the rows with one lax.sort by (inactive, era, key, row), carries each
// segment's head across it (`first`), probes the old table with a dense
// [rows, G] equality matrix, ranks first appearances with cumsums, and
// scatters the new table. Here there is no sort:
//   - era (the inclusive count of RESET rows) and the first/last reset rows
//     come from one scan block;
//   - every active row inserts its row index into a global open-addressing
//     table keyed by (era, key): an empty slot (-1) is claimed with atomicCAS,
//     an occupied one is compared by reading the immutable key/era lanes of
//     the row it holds, and a match takes atomicMin of the row index. Once
//     the launch ends each slot holds the first row of its (era, key), i.e.
//     JAX's `first`, which is the segment id every later kernel uses;
//   - the old table is probed through a hash of its used slots, kept in
//     shared memory (G = 1024: 2048 entries, 24 KB); a key held by several
//     used slots resolves to the smallest, as JAX's argmax does;
//   - allocation ranks (first appearances of keys not in the table, in every
//     era; and post-last-reset first appearances for the fresh table) are
//     exclusive scans of one flag byte per row in one block, which also
//     writes the overflow flag, the new count and the table's base;
//   - each row then computes its slot, and each allocating row writes its key
//     into its unique new slot.
// What bounds it on the card: bytes (rows x 10 B of lanes in, rows x 8 B of
// slots and segment ids out, the G-slot table in and out), microseconds at
// 3.35 TB/s; the two single-block scans, the hash probes' latency and the
// launch count (6 kernels and 2 memsets) dominate. No host sync.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

#include "common.cuh"
#include "partition.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 32;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr int kThreads = 256;
constexpr int kMaxSharedTable = 16384;  // old-table hash entries kept in shared memory

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return x;
}

// era[i] = #resets at rows <= i; bounds = (first reset row or rows, last or -1).
__global__ void __launch_bounds__(kScanThreads)
era_kernel(const bool* reset, int rows, int32_t* era, int32_t* bounds) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int first_s, last_s;
  const int tid = threadIdx.x;
  if (tid == 0) {
    first_s = rows;
    last_s = -1;
  }
  __syncthreads();
  int carry = 0;
  for (int base = 0; base < rows; base += kScanTile) {
    const int start = base + tid * kScanItems;
    unsigned flags = 0;
    int local = 0;
    for (int k = 0; k < kScanItems; ++k) {
      const int r = start + k;
      const bool f = r < rows && reset[r];
      flags |= (unsigned)f << k;
      local += f;
    }
    if (flags) {
      atomicMin(&first_s, start + __ffs((int)flags) - 1);
      atomicMax(&last_s, start + 31 - __clz((int)flags));
    }
    int total;
    int run = carry + block_excl_sum(local, warp_sums, &total);
    for (int k = 0; k < kScanItems; ++k) {
      const int r = start + k;
      if (r >= rows) break;
      run += (flags >> k) & 1u;
      era[r] = run;
    }
    carry += total;
  }
  __syncthreads();
  if (tid == 0) {
    bounds[0] = first_s;
    bounds[1] = last_s;
  }
}

// Old table: one hash entry per used slot (no key comparison: a duplicated
// key gets one entry per slot, and the probe takes the smallest).
__global__ void table_build_kernel(const int64_t* table_keys, const bool* used, int G,
                                   int tsize, int32_t* tab_hash) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= G || !used[j]) return;
  const unsigned mask = (unsigned)tsize - 1;
  unsigned h = (unsigned)mix64((unsigned long long)table_keys[j]) & mask;
  while (atomicCAS(&tab_hash[h], -1, j) != -1) h = (h + 1) & mask;
}

// Per row: the old-table slot holding its key (or -1) and, for an active
// row, its (era, key) entry in the row table.
template <bool kShared>
__global__ void insert_kernel(const int64_t* table_keys, const int64_t* keys,
                              const bool* active, const int32_t* era, int rows,
                              int tsize, const int32_t* tab_hash, int32_t* row_hash,
                              int hsize, int32_t* hpos, int32_t* tslot) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int32_t* th = tab_hash;
  const int64_t* tk = nullptr;
  if (kShared) {
    int64_t* s_key = (int64_t*)smem;
    int32_t* s_slot = (int32_t*)(s_key + tsize);
    for (int h = threadIdx.x; h < tsize; h += blockDim.x) {
      const int s = tab_hash[h];
      s_slot[h] = s;
      s_key[h] = s >= 0 ? table_keys[s] : 0;
    }
    __syncthreads();
    th = s_slot;
    tk = s_key;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  if (!active[i]) {
    hpos[i] = -1;
    tslot[i] = -1;
    return;
  }
  const long long key = keys[i];
  const unsigned tmask = (unsigned)tsize - 1;
  unsigned h = (unsigned)mix64((unsigned long long)key) & tmask;
  int t = -1;
  for (;;) {
    const int s = th[h];
    if (s < 0) break;
    const long long k = kShared ? tk[h] : table_keys[s];
    if (k == key && (t < 0 || s < t)) t = s;
    h = (h + 1) & tmask;
  }
  tslot[i] = t;

  const int my_era = era[i];
  const unsigned rmask = (unsigned)hsize - 1;
  h = (unsigned)mix64((unsigned long long)key ^ (0x9e3779b97f4a7c15ULL * (unsigned)my_era)) & rmask;
  for (;;) {
    int cur = row_hash[h];
    if (cur < 0) {
      const int prev = atomicCAS(&row_hash[h], -1, i);
      if (prev < 0) break;
      cur = prev;
    }
    // cur only ever changes to a smaller row of the same (era, key)
    if (keys[cur] == key && era[cur] == my_era) {
      atomicMin(&row_hash[h], i);
      break;
    }
    h = (h + 1) & rmask;
  }
  hpos[i] = (int)h;
}

// first[i] and the two allocation flags: bit 0 = first appearance of a key
// not in the old table; bit 1 = first appearance after the last reset.
__global__ void first_kernel(const bool* active, const int32_t* hpos,
                             const int32_t* tslot, const int32_t* row_hash,
                             const int32_t* bounds, int rows, int32_t* first,
                             int8_t* flags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const bool act = active[i];
  const int f = act ? row_hash[hpos[i]] : i;
  first[i] = f;
  const bool head = act && f == i;
  flags[i] = (int8_t)((head && tslot[i] < 0) | ((head && i > bounds[1]) << 1));
}

// Exclusive ranks of both flags, the overflow flag, the new count and the
// new table's base (a copy of the old table, or zeros after a reset).
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int8_t* flags, const int64_t* table_keys, const bool* used,
            const int32_t* n_used, const int32_t* bounds, int rows, int G, int32_t* rank_a,
            int32_t* rank_f, int64_t* new_keys, bool* new_used, int32_t* new_n,
            bool* overflow) {
  __shared__ int warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x;
  int carry_a = 0, carry_f = 0;
  for (int base = 0; base < rows; base += kScanTile) {
    const int start = base + tid * kScanItems;
    int la = 0, lf = 0;
    for (int k = 0; k < kScanItems; ++k) {
      const int r = start + k;
      if (r < rows) {
        la += flags[r] & 1;
        lf += (flags[r] >> 1) & 1;
      }
    }
    int ta, tf;
    int ra = carry_a + block_excl_sum(la, warp_sums, &ta);
    int rf = carry_f + block_excl_sum(lf, warp_sums, &tf);
    for (int k = 0; k < kScanItems; ++k) {
      const int r = start + k;
      if (r >= rows) break;
      rank_a[r] = ra;
      rank_f[r] = rf;
      ra += flags[r] & 1;
      rf += (flags[r] >> 1) & 1;
    }
    carry_a += ta;
    carry_f += tf;
  }
  const bool any_reset = bounds[1] >= 0;
  if (tid == 0) {
    const long long nu = *n_used;
    *overflow = any_reset ? carry_f > G : nu + carry_a > G;
    const long long nn = any_reset ? carry_f : nu + carry_a;
    *new_n = (int32_t)(nn < G ? nn : G);
  }
  for (int j = tid; j < G; j += kScanThreads) {
    new_keys[j] = any_reset ? 0 : table_keys[j];
    new_used[j] = any_reset ? false : used[j];
  }
}

// slot[i], and each allocating row's key written into its unique new slot.
__global__ void slot_kernel(const int64_t* keys, const bool* active, const int32_t* first,
                            const int32_t* tslot, const int8_t* flags,
                            const int32_t* rank_a, const int32_t* rank_f,
                            const int32_t* n_used, const int32_t* bounds, int rows,
                            int G, int32_t* slot, int64_t* new_keys, bool* new_used) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const int glr = bounds[1];
  const bool any_reset = glr >= 0;
  const long long nu = *n_used;
  int s = G;
  if (active[i]) {
    const int f = first[i];
    if (any_reset && i > glr) {
      const int r = rank_f[f];
      s = r < G ? r : G;
    } else if (tslot[i] >= 0) {
      s = tslot[i];
    } else {
      const long long sn = nu + rank_a[f];
      s = sn < G ? (int)sn : G;
    }
  }
  slot[i] = s;
  const int fl = flags[i];
  if (!any_reset && (fl & 1)) {
    const long long sn = nu + rank_a[i];
    if (sn < G) {
      new_keys[sn] = keys[i];
      new_used[sn] = true;
    }
  } else if (any_reset && (fl & 2) && rank_f[i] < G) {
    new_keys[rank_f[i]] = keys[i];
    new_used[rank_f[i]] = true;
  }
}

int blocks(long long count) { return (int)((count + kThreads - 1) / kThreads); }

// ---------------------------------------------------------------------------
// K33: the same assignment in P independent tables, one a partition. It
// replaces ops/group.py assign_slots (:85) under siddhi_tpu/core/partition.py's
// jax.vmap: each partition p sees its own rows (active or RESET rows whose
// partition slot is p), allocates in its own [G] table in its own order,
// overflows at its own G and resets in its own eras.
//   - pg_rows (one block of 1024 threads): each partition's rows in row
//     order (partition.cuh member_rows), and every row's default (dead
//     slot G, segment head the row itself);
//   - pg_assign (one block a partition): each active row probes its
//     partition's table (a scan of G keys, the smallest matching slot as
//     JAX's argmax), then one thread walks the partition's rows in order
//     with a small open-addressing table of (era, key) -> (first row,
//     allocation ranks), as the JAX function's cumsums rank first
//     appearances, and writes each row's slot and segment head, the
//     partition's new table, count and overflow flag.
// ---------------------------------------------------------------------------

constexpr int kPartThreads = 256;

__global__ void __launch_bounds__(kRankThreads)
pg_rows_kernel(const bool* active, const bool* reset, const int32_t* pslot, int rows, int P,
               int G, int32_t* rank, int32_t* rowlist, int32_t* part_start, int32_t* counters,
               int32_t* slot, int32_t* first) {
  __shared__ RankSmem s;
  for (int r = threadIdx.x; r < rows; r += kRankThreads) {
    slot[r] = G;
    first[r] = r;
  }
  member_rows(
      rows, P,
      [&](int r) {
        const int sl = pslot[r];
        return (active[r] || reset[r]) && sl >= 0 && sl < P ? sl : -1;
      },
      rank, rowlist, part_start, counters, s);
}

__global__ void __launch_bounds__(kPartThreads)
pg_assign_kernel(const int64_t* table_keys, const bool* used, const int32_t* n_used,
                 const int64_t* keys, const bool* active, const bool* reset, int P, int G,
                 const int32_t* rowlist, const int32_t* part_start, int64_t* new_keys,
                 bool* new_used, int32_t* new_n, int32_t* slot, int32_t* first,
                 bool* overflow, int32_t* tslot, int32_t* hrow, int32_t* hera,
                 int32_t* halloc_a, int32_t* halloc_f) {
  __shared__ int s_glr;
  const int p = blockIdx.x, tid = threadIdx.x;
  const int lo = part_start[p], c = part_start[p + 1] - lo;
  const int32_t* prow = rowlist + lo;
  const int64_t* tk = table_keys + (long long)p * G;
  const bool* tu = used + (long long)p * G;
  const int H = 2 * c + 1, hb = 2 * lo + p;  // this partition's (era, key) table
  if (tid == 0) s_glr = -1;
  __syncthreads();
  for (int i = tid; i < H; i += kPartThreads) hrow[hb + i] = -1;
  for (int i = tid; i < c; i += kPartThreads) {
    const int r = prow[i];
    int ts = -1;
    if (active[r]) {
      for (int j = 0; j < G; ++j) {
        if (tu[j] && tk[j] == keys[r]) { ts = j; break; }
      }
    } else if (reset[r]) {
      atomicMax(&s_glr, i);
    }
    tslot[r] = ts;
  }
  __syncthreads();
  const int glr = s_glr;
  const bool any_reset = glr >= 0;
  int64_t* nk = new_keys + (long long)p * G;
  bool* nu = new_used + (long long)p * G;
  for (int j = tid; j < G; j += kPartThreads) {
    nk[j] = any_reset ? 0 : tk[j];
    nu[j] = any_reset ? false : tu[j];
  }
  __syncthreads();
  if (tid != 0) return;
  const int n0 = n_used[p];
  int era = 0, na = 0, nf = 0;
  bool old_ovf = false, fresh_ovf = false;
  for (int i = 0; i < c; ++i) {
    const int r = prow[i];
    if (!active[r]) {  // a RESET row opens the next era
      ++era;
      continue;
    }
    const long long key = keys[r];
    const bool post = i > glr;
    unsigned long long h =
        mix64((unsigned long long)key ^ ((unsigned long long)era * 0x9e3779b97f4a7c15ULL));
    int at = (int)(h % (unsigned long long)H);
    while (hrow[hb + at] >= 0 &&
           !(hera[hb + at] == era && keys[hrow[hb + at]] == key)) {
      at = at + 1 == H ? 0 : at + 1;
    }
    const int e = hb + at;
    if (hrow[e] < 0) {  // the first appearance of (era, key)
      hrow[e] = r;
      hera[e] = era;
      const bool in_t = tslot[r] >= 0;
      halloc_a[e] = in_t ? -1 : na++;
      halloc_f[e] = post ? nf++ : -1;
      if (!in_t && n0 + halloc_a[e] >= G) old_ovf = true;
      if (post && halloc_f[e] >= G) fresh_ovf = true;
      if (!any_reset && !in_t && n0 + halloc_a[e] < G) {
        nk[n0 + halloc_a[e]] = key;
        nu[n0 + halloc_a[e]] = true;
      }
      if (any_reset && post && halloc_f[e] < G) {
        nk[halloc_f[e]] = key;
        nu[halloc_f[e]] = true;
      }
    }
    first[r] = hrow[e];
    const int ts = tslot[r];
    const int sa = n0 + halloc_a[e];
    const int old_slot = ts >= 0 ? ts : sa < G ? sa : G;
    const int af = halloc_f[e];
    const int fresh_slot = af >= 0 && af < G ? af : G;
    slot[r] = any_reset && post ? fresh_slot : old_slot;
  }
  overflow[p] = any_reset ? fresh_ovf : old_ovf;
  new_n[p] = any_reset ? min(nf, G) : min(n0 + na, G);
}

}  // namespace

extern "C" {

// hsize (row table) and tsize (old-table hash) are powers of two, hsize >=
// 2 rows and tsize >= 2 G; every output and scratch buffer is preallocated.
int group_assign(const int64_t* table_keys, const bool* used, const int32_t* n_used,
                 const int64_t* keys, const bool* active, const bool* reset, int G,
                 int rows, int hsize, int tsize, int64_t* new_keys, bool* new_used,
                 int32_t* new_n, int32_t* slot, int32_t* first, int32_t* bounds,
                 bool* overflow, int32_t* era, int32_t* hpos, int32_t* tslot,
                 int8_t* flags, int32_t* rank_a, int32_t* rank_f, int32_t* row_hash,
                 int32_t* tab_hash, cudaStream_t stream) {
  era_kernel<<<1, kScanThreads, 0, stream>>>(reset, rows, era, bounds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(row_hash, 0xff, sizeof(int32_t) * (size_t)hsize, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(tab_hash, 0xff, sizeof(int32_t) * (size_t)tsize, stream);
  if (err != cudaSuccess) return (int)err;
  table_build_kernel<<<blocks(G), kThreads, 0, stream>>>(table_keys, used, G, tsize, tab_hash);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (tsize <= kMaxSharedTable) {
    const size_t smem = (size_t)tsize * (sizeof(int64_t) + sizeof(int32_t));
    err = cudaFuncSetAttribute(insert_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    insert_kernel<true><<<blocks(rows), kThreads, smem, stream>>>(
        table_keys, keys, active, era, rows, tsize, tab_hash, row_hash, hsize, hpos, tslot);
  } else {
    insert_kernel<false><<<blocks(rows), kThreads, 0, stream>>>(
        table_keys, keys, active, era, rows, tsize, tab_hash, row_hash, hsize, hpos, tslot);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  first_kernel<<<blocks(rows), kThreads, 0, stream>>>(active, hpos, tslot, row_hash, bounds,
                                                      rows, first, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, kScanThreads, 0, stream>>>(flags, table_keys, used, n_used, bounds, rows,
                                              G, rank_a, rank_f, new_keys, new_used, new_n,
                                              overflow);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  slot_kernel<<<blocks(rows), kThreads, 0, stream>>>(keys, active, first, tslot, flags,
                                                     rank_a, rank_f, n_used, bounds, rows, G,
                                                     slot, new_keys, new_used);
  return (int)cudaGetLastError();
}

// K33: counters [P] int32 scratch (used when P > 8192); tslot [rows];
// hrow, hera, halloc_a, halloc_f [2 rows + P]; overflow [P]
int pg_assign(const int64_t* table_keys, const bool* used, const int32_t* n_used,
              const int64_t* keys, const bool* active, const bool* reset, const int32_t* pslot,
              int P, int G, int rows, int32_t* rank, int32_t* rowlist, int32_t* part_start,
              int32_t* counters, int64_t* new_keys, bool* new_used, int32_t* new_n,
              int32_t* slot, int32_t* first, bool* overflow, int32_t* tslot, int32_t* hrow,
              int32_t* hera, int32_t* halloc_a, int32_t* halloc_f, cudaStream_t stream) {
  pg_rows_kernel<<<1, kRankThreads, 0, stream>>>(active, reset, pslot, rows, P, G, rank,
                                                 rowlist, part_start, counters, slot, first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pg_assign_kernel<<<P, kPartThreads, 0, stream>>>(
      table_keys, used, n_used, keys, active, reset, P, G, rowlist, part_start, new_keys,
      new_used, new_n, slot, first, overflow, tslot, hrow, hera, halloc_a, halloc_f);
  return (int)cudaGetLastError();
}

}  // extern "C"
