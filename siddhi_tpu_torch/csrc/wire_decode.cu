// Fused-ingest wire decode for Hopper (sm_90a): K encoded micro-batches ->
// columnar [K, cap] lanes, in one launch.
//
// Replaces siddhi_tpu/core/wire.py build_codec.decode (with
// siddhi_tpu/core/event.py _bitcast_split), which the JAX chunk program runs
// once per micro-batch inside its lax.scan. Each wire row holds one
// micro-batch as byte sections (core/wire.py build_codec): the timestamp
// lane (__tsd__), then one section per shipped column: wide (the physical
// bytes), narrow (a signed downcast), dict (codes + a per-batch dictionary),
// delta (an int64 base + signed diffs) or bitpack (1 bit a row, big-endian
// within a byte). Columns that no query reads are not shipped and decode to
// their null value.
//
// Grid (section, k): one block decodes one section of one micro-batch. The
// sections sit at arbitrary byte offsets (a 2-byte lane of 33 rows puts the
// next lane at offset 66, and row k starts at k * row_bytes), so every value
// is assembled from bytes; only the outputs, which PyTorch allocates aligned,
// are stored as typed words. The diff-coded timestamp lane (int32 running
// sum) and delta lanes (int64 running sum) take a block-wide inclusive scan
// in shared memory over B in chunks of kThreads rows, carrying the chunk
// total; sums wrap like the JAX cumsums (unsigned arithmetic).
// What bounds it on the card: bytes (the wire read once, every decoded lane
// written once). The quickstart wire is 8 B a row in and 26 B a row out (ts 8,
// symbol 4, price 4, the unshipped volume's null fill 8, valid 1, kind 1):
// about 9 MiB a chunk at K = 32, B = 32768, some 3 us at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxSections = 32;  // keep equal to core/wire.py _MAX_SECTIONS

// keep in step with core/wire.py SEC_*
enum SectionKind { kTsd = 0, kCopy = 1, kDict = 2, kDelta = 3, kBitpack = 4, kFill = 5 };

struct Section {
  long long off;   // byte offset of the section in a wire row
  long long fill;  // kFill: the null value's bits
  void* out;       // [K, cap] output lane (kTsd: the int64 timestamps)
  int kind;
  int wsz;      // wire itemsize
  int osz;      // output itemsize
  int card;     // kDict: dictionary slots
  int is_bool;  // the output lane is bool: store (value != 0)
};

struct Plan {
  Section sec[kMaxSections];
};

__device__ __forceinline__ unsigned long long load_le(const unsigned char* p, int n) {
  unsigned long long v = 0;
  for (int b = 0; b < n; ++b) v |= (unsigned long long)p[b] << (8 * b);
  return v;
}

__device__ __forceinline__ unsigned long long sign_extend(unsigned long long v, int n) {
  if (n >= 8) return v;
  const int shift = 64 - 8 * n;
  return (unsigned long long)((long long)(v << shift) >> shift);
}

__device__ __forceinline__ void store(void* out, long long i, int osz,
                                      unsigned long long v) {
  switch (osz) {
    case 1: static_cast<unsigned char*>(out)[i] = (unsigned char)v; break;
    case 2: static_cast<unsigned short*>(out)[i] = (unsigned short)v; break;
    case 4: static_cast<unsigned int*>(out)[i] = (unsigned int)v; break;
    default: static_cast<unsigned long long*>(out)[i] = v; break;
  }
}

// Inclusive scan of one value per thread over the block (Hillis-Steele in
// shared memory); *total gets the block's sum. Every thread must call it.
__device__ unsigned long long block_inclusive(unsigned long long x,
                                              unsigned long long* total) {
  __shared__ unsigned long long buf[2][kThreads];
  const int t = threadIdx.x;
  int cur = 0;
  buf[cur][t] = x;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    unsigned long long v = buf[cur][t];
    if (t >= d) v += buf[cur][t - d];
    buf[cur ^ 1][t] = v;
    cur ^= 1;
    __syncthreads();
  }
  const unsigned long long r = buf[cur][t];
  *total = buf[cur][kThreads - 1];
  __syncthreads();  // buf is reused by the caller's next call
  return r;
}

__global__ void wire_decode_kernel(const unsigned char* wire, const int* counts,
                                   const long long* bases, long long row_bytes, int cap,
                                   Plan plan, bool* valid, signed char* kind) {
  const Section s = plan.sec[blockIdx.x];
  const int k = blockIdx.y;
  const unsigned char* sec = wire + (long long)k * row_bytes + s.off;
  const long long row0 = (long long)k * cap;
  // every thread runs the same number of chunks: the scans need all of them
  unsigned long long carry = 0;
  for (int i0 = 0; i0 < cap; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    const bool in = i < cap;
    switch (s.kind) {
      case kTsd: {
        unsigned long long d = in ? sign_extend(load_le(sec + (long long)i * s.wsz, s.wsz), s.wsz) : 0;
        if (s.wsz < 4) {  // diff-coded: int32 running sum of the diffs
          unsigned long long tot;
          d = carry + block_inclusive(d, &tot);
          carry += tot;
        }
        if (in) {
          const long long off32 = (long long)(int)(unsigned int)d;
          store(s.out, row0 + i, 8, (unsigned long long)bases[k] + (unsigned long long)off32);
          valid[row0 + i] = i < counts[k];
          kind[row0 + i] = 0;
        }
        break;
      }
      case kCopy: {
        if (in) {
          unsigned long long v = load_le(sec + (long long)i * s.wsz, s.wsz);
          if (s.is_bool) v = v != 0;
          else if (s.wsz < s.osz) v = sign_extend(v, s.wsz);
          store(s.out, row0 + i, s.osz, v);
        }
        break;
      }
      case kDict: {
        if (in) {
          unsigned long long code = load_le(sec + (long long)i * s.wsz, s.wsz);
          if (code >= (unsigned long long)s.card) code = s.card - 1;  // jnp gathers clamp
          const unsigned char* vals = sec + (long long)cap * s.wsz;
          store(s.out, row0 + i, s.osz, load_le(vals + code * s.osz, s.osz));
        }
        break;
      }
      case kDelta: {
        unsigned long long d = in ? sign_extend(load_le(sec + 8 + (long long)i * s.wsz, s.wsz), s.wsz) : 0;
        unsigned long long tot;
        d = carry + block_inclusive(d, &tot);
        carry += tot;
        if (in) store(s.out, row0 + i, s.osz, load_le(sec, 8) + d);
        break;
      }
      case kBitpack: {
        if (in) store(s.out, row0 + i, 1, (sec[i >> 3] >> (7 - (i & 7))) & 1);
        break;
      }
      default: {  // kFill
        if (in) store(s.out, row0 + i, s.osz, (unsigned long long)s.fill);
        break;
      }
    }
  }
}

}  // namespace

extern "C" {

// sec_int: n_sec x {kind, wire itemsize, output itemsize, dict card, bool out}
// sec_ll:  n_sec x {byte offset, fill bits}; sec_out: n_sec output pointers.
// All three are host arrays; section 0 is the timestamp lane.
int wire_decode(const unsigned char* wire, const int* counts, const long long* bases,
                int K, long long row_bytes, int cap, int n_sec, const int* sec_int,
                const long long* sec_ll, void* const* sec_out, bool* valid,
                signed char* kind, cudaStream_t stream) {
  if (n_sec < 1 || n_sec > kMaxSections || K < 1 || cap < 1) return (int)cudaErrorInvalidValue;
  Plan plan;
  for (int j = 0; j < n_sec; ++j) {
    Section& s = plan.sec[j];
    s.kind = sec_int[5 * j];
    s.wsz = sec_int[5 * j + 1];
    s.osz = sec_int[5 * j + 2];
    s.card = sec_int[5 * j + 3];
    s.is_bool = sec_int[5 * j + 4];
    s.off = sec_ll[2 * j];
    s.fill = sec_ll[2 * j + 1];
    s.out = sec_out[j];
  }
  for (int j = n_sec; j < kMaxSections; ++j) plan.sec[j] = Section{};
  dim3 grid(n_sec, K);
  wire_decode_kernel<<<grid, kThreads, 0, stream>>>(wire, counts, bases, row_bytes, cap,
                                                    plan, valid, kind);
  return (int)cudaGetLastError();
}

}  // extern "C"
