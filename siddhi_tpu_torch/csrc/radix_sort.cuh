// A stable LSD radix sort of rows by nw unsigned 64-bit words with an int32
// payload (the row), for Hopper (sm_90a). Shared by K46 (csrc/order_limit.cu,
// the order-by words) and K22's index build (csrc/table_index.cu, the (empty,
// key) words).
//
// The rows are ordered by word 0 (the most significant), then word 1, ...,
// then row: a pass orders them stably by one byte of one word, from the least
// significant byte of the last word to the most significant byte of word 0.
// A byte that no row changes (the word's OR and AND agree on it) costs no
// pass. The pass list is worked out on the device from those ORs and ANDs,
// so the host reads nothing back, and the ping-pong buffer a pass reads
// follows from its index in that list.
//
// Above one tile (kSortTile = 2,048 rows) the sort is one cooperative,
// persistent launch (`radix_sort_grid`): at most as many blocks as fit on the
// card at once, each walking tiles, with grid barriers between phases:
//   1. the caller's encode writes the words word-major (words[w * R + r])
//      and each block's OR and NAND of every word;
//   2. the pass list, and the digit counts of every pass at once (they do
//      not depend on the order, as in Onesweep);
//   3. each pass, tile by tile: the rows ranked stably within the tile by
//      warp-level multisplit (each lane's peers of equal digit from ballots,
//      per-warp digit counters in shared memory, then a block scan over the
//      256 digits), each digit's offset among the earlier tiles by decoupled
//      look-back, then a scatter through shared memory so a digit's run is
//      written in order.
// The current word moves with the payload, read with coalesced loads; a word
// is gathered through the payload once, by the first pass of that word. The
// last pass hands each row's final place to the caller (`emit`).
// At most one tile of rows is sorted by one block in shared memory
// (`radix_sort_block`), each word encoded where it is first read.
//
// Bound: bytes. A pass moves its word and payload once each way (24 bytes a
// row); below some 10^6 rows the grid barriers between phases and the
// look-back's wait on the earlier tiles of a pass cost more than the bytes.

#pragma once

#include <cooperative_groups.h>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kSortThreads = 256;  // a block of the grid sort
constexpr int kSortIPT = 8;        // rows a thread of a tile
constexpr int kSortTile = kSortThreads * kSortIPT;  // 2,048 rows
constexpr int kBlockSortThreads = 1024;             // the one-block sort
constexpr int kBlockSortIPT = kSortTile / kBlockSortThreads;
constexpr int kMaxSortWords = 10;
constexpr int kMaxPasses = 8 * kMaxSortWords;
constexpr int kEncodeRows = 8;  // rows a thread encodes at once
// a tile's look-back state for one digit: its count, and whether that is
// the tile's own (kAgg) or inclusive of every earlier tile (kInc); 0: not
// yet published
constexpr unsigned kAgg = 1u << 30, kInc = 2u << 30, kCountMask = kAgg - 1u;
constexpr int kMaxGridRows = 1 << 30;  // the rows a look-back state can count

template <int THREADS, int IPT>
struct TileSmem {
  unsigned long long key[THREADS * IPT];
  int32_t val[THREADS * IPT];
  unsigned short wcnt[THREADS / 32][256];  // a warp's digit counters
  int dstart[256];                         // a digit's first place in the tile
  int ws[32];
};

struct PassList {
  int n;
  unsigned char w[kMaxPasses];
  unsigned char b[kMaxPasses];
};

// Shared memory of a grid sort's block.
struct GridSmem {
  union {
    TileSmem<kSortThreads, kSortIPT> t;
    unsigned hist[8][256];  // the counts of one word's bytes
  } u;
  unsigned long long red[2][kMaxSortWords][32];
  int gofs[256];
  PassList pl;
};

// The grid sort's scratch, carved from the caller's workspace.
struct RadixWork {
  unsigned long long* words;   // [nw * R], word-major
  unsigned long long* part;    // [2 * kMaxSortWords * blocks]: each block's OR, then NAND
  unsigned* hist;              // [nw * 8 * 256]: the digit counts of each byte
  unsigned* status[2];         // [tiles * 256] each: the look-back states, by pass parity
  unsigned long long* key[2];  // [R] each: the current word, ping-pong
  int32_t* val[2];             // [R] each: the payload, ping-pong
};

// Consecutive 256-byte aligned regions of a workspace (base null: sizes only).
struct Carve {
  char* base;
  size_t off;
  template <class T>
  T* take(size_t n) {
    off = (off + 255) & ~(size_t)255;
    T* p = base != nullptr ? reinterpret_cast<T*>(base + off) : nullptr;
    off += n * sizeof(T);
    return p;
  }
};

__host__ __device__ __forceinline__ int sort_tiles(int R) {
  return (int)(((long long)R + kSortTile - 1) / kSortTile);
}

// The most blocks a grid sort of R rows takes: one a tile for the passes, and
// up to a row a thread for the encode and the counts.
__host__ __device__ __forceinline__ int sort_blocks(int R) {
  const int rows = (int)(((long long)R + kSortThreads - 1) / kSortThreads);
  const int tiles = sort_tiles(R);
  return rows > tiles ? rows : tiles;
}

inline RadixWork carve_radix(Carve& c, int R, int nw) {
  RadixWork w;
  const size_t tiles = (size_t)sort_tiles(R);
  w.words = c.take<unsigned long long>((size_t)nw * R);
  w.part = c.take<unsigned long long>((size_t)2 * kMaxSortWords * sort_blocks(R));
  w.hist = c.take<unsigned>((size_t)8 * nw * 256);
  for (int b = 0; b < 2; ++b) w.status[b] = c.take<unsigned>(tiles * 256);
  for (int b = 0; b < 2; ++b) {
    w.key[b] = c.take<unsigned long long>((size_t)R);
    w.val[b] = c.take<int32_t>((size_t)R);
  }
  return w;
}

// The blocks of a cooperative launch of `kernel` (kSortThreads threads, static
// shared memory only) for R rows: sort_blocks(R), at most as many as the card
// holds at once (the occupancy is asked once a device).
template <class Kernel>
inline cudaError_t coop_blocks(Kernel kernel, int R, int* blocks) {
  static int per_sm[64], sms[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    int n = 0, m = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kSortThreads, 0);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorCooperativeLaunchTooLarge;
    sms[dev] = m;
    per_sm[dev] = n;
  }
  const long long most = (long long)per_sm[dev] * sms[dev];
  const int want = sort_blocks(R);
  *blocks = want < most ? want : (int)most;
  return cudaSuccess;
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

constexpr int kLookBack = 32;  // earlier tiles' states read at once

// Digit d's count over the tiles before `tile` in this pass: the states of
// kLookBack earlier tiles are read at once, summed back to the nearest one
// that holds its inclusive prefix, and read again while one of them is not
// yet published.
__device__ __forceinline__ int look_back(const unsigned* status, int tile, int d) {
  int prefix = 0;
  for (int p = tile - 1;; p -= kLookBack) {
    for (;;) {
      unsigned v[kLookBack];
#pragma unroll
      for (int q = 0; q < kLookBack; ++q)
        v[q] = p - q >= 0 ? ld_relaxed(status + (size_t)(p - q) * 256 + d) : kInc;
      int sum = 0, state = 0;  // state 0: go on back, 1: done, 2: wait
#pragma unroll
      for (int q = 0; q < kLookBack; ++q) {
        if (state == 0) {
          if ((v[q] & (kAgg | kInc)) == 0u) {
            state = 2;
          } else {
            sum += (int)(v[q] & kCountMask);
            if (v[q] & kInc) state = 1;
          }
        }
      }
      if (state == 2) continue;
      prefix += sum;
      if (state == 1) return prefix;
      break;
    }
  }
}

// Word w's OR (o) and NAND (n) over this warp into red[.][w][warp]. Every
// thread of the warp calls it.
__device__ __forceinline__ void warp_or(int w, unsigned long long o, unsigned long long n,
                                        unsigned long long (&red)[2][kMaxSortWords][32]) {
  for (int d = 16; d > 0; d >>= 1) {
    o |= __shfl_xor_sync(kFull, o, d);
    n |= __shfl_xor_sync(kFull, n, d);
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][w][threadIdx.x >> 5] = o;
    red[1][w][threadIdx.x >> 5] = n;
  }
}

// After warp_or of words 0..nw-1 by every warp: the block's OR and NAND of
// word w in red[0][w][0] and red[1][w][0]. Every thread of the block calls it.
template <int THREADS>
__device__ void fold_or(int nw, unsigned long long (&red)[2][kMaxSortWords][32]) {
  __syncthreads();
  if ((int)threadIdx.x < nw) {
    unsigned long long a = 0, b = 0;
    for (int k = 0; k < THREADS / 32; ++k) {
      a |= red[0][threadIdx.x][k];
      b |= red[1][threadIdx.x][k];
    }
    red[0][threadIdx.x][0] = a;
    red[1][threadIdx.x][0] = b;
  }
  __syncthreads();
}

// The lanes of the warp whose digit (0..256, 256: no item) equals this
// lane's, from nine ballots over its bits. Every lane of the warp calls
// it.
__device__ __forceinline__ unsigned match_digit(unsigned d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    const unsigned vote = __ballot_sync(kFull, (d >> b) & 1u);
    peers &= ((d >> b) & 1u) ? vote : ~vote;
  }
  return peers;
}

// The passes: every byte some row changes, the last word's least significant
// byte first. One thread calls it.
__device__ void make_passes(int nw, const unsigned long long (&red)[2][kMaxSortWords][32],
                            PassList& pl) {
  int n = 0;
  for (int w = nw - 1; w >= 0; --w) {
    const unsigned long long diff = red[0][w][0] & red[1][w][0];  // some 1 and some 0
    for (int b = 0; b < 8; ++b) {
      if ((diff >> (8 * b)) & 0xffull) {
        pl.w[n] = (unsigned char)w;
        pl.b[n] = (unsigned char)b;
        ++n;
      }
    }
  }
  pl.n = n;
}

// Stable ranks of a tile's items by digit: thread item j (tile place
// warp * 32 * IPT + j * 32 + lane) has digit d[j] (256: no item); pos[j]
// gets its place in the tile ordered by digit, t.dstart[x] the first place
// of digit x, and *count (threads < 256) the count of digit threadIdx.x.
// Every thread of the block calls it.
template <int THREADS, int IPT>
__device__ void tile_rank(const unsigned (&d)[IPT], int (&pos)[IPT], TileSmem<THREADS, IPT>& t,
                          int* count) {
  constexpr int kWarps = THREADS / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int x = tid; x < kWarps * 256; x += THREADS) (&t.wcnt[0][0])[x] = 0;
  __syncthreads();
  unsigned short* c = t.wcnt[warp];
  unsigned peers_of[IPT];  // every round's votes first: they do not wait on the counters
#pragma unroll
  for (int j = 0; j < IPT; ++j) peers_of[j] = match_digit(d[j]);
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const unsigned peers = peers_of[j];
    const int within = __popc(peers & ((1u << lane) - 1u));
    const int before = d[j] < 256u ? (int)c[d[j]] : 0;
    __syncwarp();
    if (d[j] < 256u && within == 0) c[d[j]] = (unsigned short)(before + __popc(peers));
    __syncwarp();
    pos[j] = before + within;  // the rank within the warp, for now
  }
  __syncthreads();
  int total = 0;
  if (tid < 256) {
    for (int w = 0; w < kWarps; ++w) {  // the warps before, digit tid
      const int x = t.wcnt[w][tid];
      t.wcnt[w][tid] = (unsigned short)total;
      total += x;
    }
  }
  int all;
  const int start = block_excl_sum(total, t.ws, &all);
  if (tid < 256) t.dstart[tid] = start;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < IPT; ++j)
    pos[j] = d[j] < 256u ? t.dstart[d[j]] + t.wcnt[warp][d[j]] + pos[j] : -1;
  *count = total;
}

// One block sorts rows 0..R-1 (R <= THREADS * IPT); word(w, r) is row r's
// word w. Leaves the rows in order in t.val[0..R). red shares memory with t
// in the caller's union. Every thread of the block calls it.
template <int THREADS, int IPT, class WordFn>
__device__ void radix_sort_block(int R, int nw, WordFn word, TileSmem<THREADS, IPT>& t,
                                 unsigned long long (&red)[2][kMaxSortWords][32], PassList& pl) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int w = 0; w < nw; ++w) {
    unsigned long long o = 0ull, n = 0ull;
    for (int r = tid; r < R; r += THREADS) {
      const unsigned long long x = word(w, r);
      o |= x;
      n |= ~x;
    }
    warp_or(w, o, n, red);
  }
  fold_or<THREADS>(nw, red);
  if (tid == 0) make_passes(nw, red, pl);
  __syncthreads();  // red is dead from here: t takes its memory
  const int K = pl.n;
  for (int k = 0; k < K; ++k) {
    const int w = pl.w[k], sh = 8 * pl.b[k];
    const bool first = k == 0 || pl.w[k - 1] != w;
    unsigned long long key[IPT];
    int32_t val[IPT];
    unsigned d[IPT];
    int pos[IPT];
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      const int it = warp * 32 * IPT + j * 32 + lane;
      key[j] = 0ull;
      val[j] = 0;
      d[j] = 256u;
      if (it < R) {
        val[j] = k == 0 ? it : t.val[it];
        key[j] = first ? word(w, val[j]) : t.key[it];
        d[j] = (unsigned)((key[j] >> sh) & 0xffull);
      }
    }
    int cnt;
    tile_rank<THREADS, IPT>(d, pos, t, &cnt);
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      if (d[j] < 256u) {
        t.key[pos[j]] = key[j];
        t.val[pos[j]] = val[j];
      }
    }
    __syncthreads();
  }
  if (K == 0) {
    for (int r = tid; r < R; r += THREADS) t.val[r] = r;
    __syncthreads();
  }
}

// The rows whose byte b of word w is d, after radix_sort_grid has returned.
__device__ __forceinline__ int radix_count(const RadixWork& wk, const GridSmem& s, int R, int w,
                                           int b, int d) {
  const unsigned long long o = s.red[0][w][0], n = s.red[1][w][0];  // the word's OR and NAND
  if (((o & n) >> (8 * b)) & 0xffull) return (int)__ldcg(wk.hist + ((size_t)w * 8 + b) * 256 + d);
  return (int)((o >> (8 * b)) & 0xffull) == d ? R : 0;  // every row holds one value
}

struct NoHook {
  __device__ void operator()() const {}
};

// Every block of a cooperative launch of at most sort_blocks(R) blocks of
// kSortThreads threads calls it (R > 0). word(w, r) is row r's word w, asked
// once a row and word, in phase 1; emit(place, row) gets each row's place in
// the order (no barrier after it: a caller reading the order from other
// blocks syncs the grid first). after_encode() runs in every block after
// phase 1's grid barrier, and what it writes is seen by every emit.
template <class WordFn, class EmitFn, class HookFn = NoHook>
__device__ void radix_sort_grid(int R, int nw, WordFn word, const RadixWork& wk, GridSmem& s,
                                EmitFn emit, HookFn after_encode = HookFn()) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, tiles = sort_tiles(R);
  const int row0 = blockIdx.x * kSortThreads, row_step = G * kSortThreads;

  // 1. the words; each block's OR and NAND of every word; the counts and
  // look-back states zeroed
  for (int w = 0; w < nw; ++w) {
    unsigned long long o = 0ull, n = 0ull;
    for (int base = row0; base < R; base += row_step * kEncodeRows) {
      unsigned long long x[kEncodeRows];  // the loads first, then the stores
#pragma unroll
      for (int j = 0; j < kEncodeRows; ++j) {
        const int r = base + j * row_step + tid;
        x[j] = r < R ? word(w, r) : 0ull;
      }
#pragma unroll
      for (int j = 0; j < kEncodeRows; ++j) {
        const int r = base + j * row_step + tid;
        if (r < R) {
          wk.words[(size_t)w * R + r] = x[j];
          o |= x[j];
          n |= ~x[j];
        }
      }
    }
    warp_or(w, o, n, s.red);
  }
  fold_or<kSortThreads>(nw, s.red);
  if (tid < nw) {
    wk.part[(size_t)tid * G + blockIdx.x] = s.red[0][tid][0];
    wk.part[(size_t)(kMaxSortWords + tid) * G + blockIdx.x] = s.red[1][tid][0];
  }
  for (int x = row0 + tid; x < 8 * nw * 256; x += row_step) wk.hist[x] = 0u;
  for (long long x = row0 + tid; x < (long long)tiles * 256; x += row_step)
    wk.status[0][x] = wk.status[1][x] = 0u;
  grid.sync();
  after_encode();

  // 2. the pass list; the digit counts of every byte that varies, word by
  // word (they do not depend on the order, as in Onesweep)
  for (int w = 0; w < nw; ++w) {
    unsigned long long o = 0ull, n = 0ull;
    for (int b = tid; b < G; b += kSortThreads) {
      o |= __ldcg(wk.part + (size_t)w * G + b);
      n |= __ldcg(wk.part + (size_t)(kMaxSortWords + w) * G + b);
    }
    warp_or(w, o, n, s.red);
  }
  fold_or<kSortThreads>(nw, s.red);
  if (tid == 0) make_passes(nw, s.red, s.pl);
  __syncthreads();
  const int K = s.pl.n;
  for (int w = 0; w < nw; ++w) {
    const unsigned long long diff = s.red[0][w][0] & s.red[1][w][0];
    unsigned bytes = 0u;
    for (int b = 0; b < 8; ++b) bytes |= ((diff >> (8 * b)) & 0xffull) != 0ull ? 1u << b : 0u;
    if (bytes == 0u) continue;
    for (int x = tid; x < 8 * 256; x += kSortThreads) (&s.u.hist[0][0])[x] = 0u;
    __syncthreads();
    for (int base = row0; base < R; base += row_step * kSortIPT) {
      unsigned long long x[kSortIPT];
#pragma unroll
      for (int j = 0; j < kSortIPT; ++j) {
        const int r = base + j * row_step + tid;
        x[j] = r < R ? __ldcg(wk.words + (size_t)w * R + r) : 0ull;
      }
#pragma unroll
      for (int j = 0; j < kSortIPT; ++j) {
        if (base + j * row_step + tid < R) {
          for (unsigned m = bytes; m != 0u; m &= m - 1u) {
            const int b = __ffs(m) - 1;
            atomicAdd(&s.u.hist[b][(int)((x[j] >> (8 * b)) & 0xffull)], 1u);
          }
        }
      }
    }
    __syncthreads();
    for (int x = tid; x < 8 * 256; x += kSortThreads) {
      const unsigned v = (&s.u.hist[0][0])[x];
      if (v != 0u) atomicAdd(&wk.hist[(size_t)w * 8 * 256 + x], v);
    }
    __syncthreads();
  }
  grid.sync();

  // 3. the passes; dbase: the rows of the digits below this thread's, over
  // the whole array
  auto counts = [&](int k) {  // pass k's count of digit tid
    return (int)__ldcg(wk.hist + ((size_t)s.pl.w[k] * 8 + s.pl.b[k]) * 256 + tid);
  };
  int all;
  int dbase = K > 0 ? block_excl_sum(counts(0), s.u.t.ws, &all) : 0;
  for (int k = 0; k < K; ++k) {
    const int w = s.pl.w[k], sh = 8 * s.pl.b[k];
    const bool first = k == 0 || s.pl.w[k - 1] != w, last = k == K - 1;
    const unsigned long long* words = wk.words + (size_t)w * R;
    const unsigned long long* kin = wk.key[k & 1];
    const int32_t* vin = wk.val[k & 1];
    unsigned long long* kout = wk.key[(k + 1) & 1];
    int32_t* vout = wk.val[(k + 1) & 1];
    unsigned* status = wk.status[k & 1];
    if (k > 0) {  // the last pass's states, zeroed for the next pass
      for (int tile = blockIdx.x; tile < tiles; tile += G)
        wk.status[(k + 1) & 1][(size_t)tile * 256 + tid] = 0u;
    }
    for (int tile = blockIdx.x; tile < tiles; tile += G) {
      const int base = tile * kSortTile;
      const int rows = R - base < kSortTile ? R - base : kSortTile;
      unsigned long long key[kSortIPT];
      int32_t val[kSortIPT];
      unsigned d[kSortIPT];
      int pos[kSortIPT];
#pragma unroll
      for (int j = 0; j < kSortIPT; ++j) {
        const int it = warp * 32 * kSortIPT + j * 32 + lane;
        key[j] = 0ull;
        val[j] = 0;
        d[j] = 256u;
        if (it < rows) {
          const int i = base + it;
          val[j] = k == 0 ? i : __ldcg(vin + i);
          key[j] = first ? __ldcg(words + val[j]) : __ldcg(kin + i);
          d[j] = (unsigned)((key[j] >> sh) & 0xffull);
        }
      }
      int cnt;
      tile_rank<kSortThreads, kSortIPT>(d, pos, s.u.t, &cnt);
      unsigned* mine = status + (size_t)tile * 256 + tid;
      st_relaxed(mine, (tile == 0 ? kInc : kAgg) | (unsigned)cnt);
#pragma unroll
      for (int j = 0; j < kSortIPT; ++j) {  // the tile in digit order
        if (d[j] < 256u) {
          s.u.t.key[pos[j]] = key[j];
          s.u.t.val[pos[j]] = val[j];
        }
      }
      // decoupled look-back: this tile's count of digit tid is published;
      // the counts of the earlier tiles back to one that holds its prefix
      const int prefix = tile == 0 ? 0 : look_back(status, tile, tid);
      if (tile > 0) st_relaxed(mine, kInc | (unsigned)(prefix + cnt));
      s.gofs[tid] = dbase + prefix - s.u.t.dstart[tid];
      __syncthreads();
      for (int x = tid; x < rows; x += kSortThreads) {
        const unsigned long long kk = s.u.t.key[x];
        const int at = s.gofs[(int)((kk >> sh) & 0xffull)] + x;
        if (last) {
          emit(at, (int)s.u.t.val[x]);
        } else {
          kout[at] = kk;
          vout[at] = s.u.t.val[x];
        }
      }
      __syncthreads();
    }
    if (!last) {
      dbase = block_excl_sum(counts(k + 1), s.u.t.ws, &all);
      grid.sync();
    }
  }
  if (K == 0) {
    for (int r = row0 + tid; r < R; r += row_step) emit(r, r);
  }
}

}  // namespace
