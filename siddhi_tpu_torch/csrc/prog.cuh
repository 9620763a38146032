// The postfix programs' interpreter, shared by the pattern scan (K16,
// csrc/pattern_scan.cu, its condition programs: core/pattern.py
// CondProgram) and the table kernels (K23 csrc/table_match.cu and K24
// csrc/table_scan.cu, table programs: ops/table.py TableProgram; K21 and
// K22 use its value helpers). Instructions are 5 int64 words (op, a, b, c,
// d). Opcode 3, OP_OPERAND, is the one read that differs by source: a token
// capture (ref, k, lane, ty) in K16, a table lane (lane, ty) at the slot in
// K23/K24. Its semantics are the executor's (siddhi_tpu_torch/core/
// executor.py): numeric promotion, Java integer division and remainder with
// x / 0 = -1 and x % 0 = x, fmod, comparisons false on a null operand.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kMaxStack = 16;
constexpr int kMaxLanes = 32;  // ops/table.py MAX_LANES (and MAX_REGS)
constexpr int kMaxProgs = kMaxLanes + 1;

enum { TY_BOOL = 0, TY_INT = 1, TY_LONG = 2, TY_FLOAT = 3, TY_ID = 4 };
enum {
  OP_REG = 1, OP_CONST = 2, OP_OPERAND = 3, OP_ARITH = 4, OP_CMP = 5,
  OP_AND = 6, OP_OR = 7, OP_NOT = 8, OP_ISNULL = 9
};

union Val {
  long long i;
  float f;
};

// up to kMaxLanes typed device arrays (registers [B] or table lanes [C])
struct LaneSet {
  void* p[kMaxLanes];
  int ty[kMaxLanes];
  int n;
};

// a LaneSet of n arrays from host arrays of pointers and types (null: none)
inline void fill_lanes(LaneSet* s, int n, void* const* p, const int* ty) {
  s->n = n;
  for (int k = 0; k < kMaxLanes; ++k) {
    s->p[k] = k < n && p != nullptr ? p[k] : nullptr;
    s->ty[k] = k < n && ty != nullptr ? ty[k] : 0;
  }
}

__device__ __forceinline__ Val load_elem(const void* base, long long i, int ty) {
  Val v;
  switch (ty) {
    case TY_FLOAT: v.f = ((const float*)base)[i]; break;
    case TY_LONG: v.i = ((const long long*)base)[i]; break;
    case TY_BOOL: v.i = ((const bool*)base)[i] ? 1 : 0; break;
    default: v.i = ((const int32_t*)base)[i]; break;
  }
  return v;
}

__device__ __forceinline__ void store_elem(void* base, long long i, int ty, Val v) {
  switch (ty) {
    case TY_FLOAT: ((float*)base)[i] = v.f; break;
    case TY_LONG: ((long long*)base)[i] = v.i; break;
    case TY_BOOL: ((bool*)base)[i] = v.i != 0; break;
    default: ((int32_t*)base)[i] = (int32_t)v.i; break;
  }
}

// a float as int32 (to_long false) or int64, as XLA converts (core/types.py
// convert_to): NaN is 0, a value at or past the type's range its max or min,
// else truncated toward zero. The bounds -2^31 and -2^63 are exact floats
// (float32 rounds INT_MAX and INT64_MAX up to their negations).
__device__ __forceinline__ long long float_to_int(float f, bool to_long) {
  if (isnan(f)) return 0;
  if (to_long) {
    if (f >= 9223372036854775808.0f) return 0x7fffffffffffffffLL;
    if (f <= -9223372036854775808.0f) return (long long)0x8000000000000000ULL;
    return __float2ll_rz(f);
  }
  if (f >= 2147483648.0f) return 0x7fffffff;
  if (f <= -2147483648.0f) return -0x7fffffff - 1;
  return __float2int_rz(f);
}

// a value of type `from` as type `to`, as core/types.py convert_to (float to
// int saturates, NaN to 0; bool is value != 0)
__device__ __forceinline__ Val convert(Val v, int from, int to) {
  Val r;
  r.i = 0;
  if (to == TY_FLOAT) {
    if (from == TY_FLOAT) return v;
    r.f = from == TY_LONG ? __ll2float_rn(v.i) : __int2float_rn((int)v.i);
  } else if (to == TY_BOOL) {
    r.i = from == TY_FLOAT ? (v.f != 0.0f) : (v.i != 0);
  } else if (to == TY_LONG) {
    r.i = from == TY_FLOAT ? float_to_int(v.f, true) : v.i;
  } else {  // TY_INT, TY_ID: int32
    r.i = from == TY_FLOAT ? float_to_int(v.f, false) : (long long)(int)v.i;
  }
  return r;
}

// equality of two values of one physical type as the JAX package's `==`
// (NaN equals nothing; a float subnormal equals zero, flush_subnormal)
__device__ __forceinline__ bool raw_eq(Val a, Val b, int ty) {
  switch (ty) {
    case TY_FLOAT: return flush_subnormal(a.f) == flush_subnormal(b.f);
    case TY_LONG: return a.i == b.i;
    case TY_BOOL: return (a.i != 0) == (b.i != 0);
    default: return (int)a.i == (int)b.i;
  }
}

__device__ __forceinline__ bool not_null(Val v, int ty) {
  switch (ty) {
    case TY_FLOAT: return !isnan(v.f);
    case TY_INT: return (int)v.i != (int)0x80000000;
    case TY_LONG: return v.i != (long long)0x8000000000000000ULL;
    case TY_ID: return v.i != 0;
    default: return true;
  }
}

// a value's place in the sort's total order, as an unsigned integer: a
// float's -0.0, 0.0 and subnormals are one value and every NaN one value
// after +inf (the JAX sort canonicalises them so, under XLA's flush), an int
// its offset binary
__device__ __forceinline__ unsigned long long total_key(Val v, int ty) {
  switch (ty) {
    case TY_FLOAT: {
      const float f = flush_subnormal(v.f);
      unsigned int u;
      if (f == 0.0f) u = 0u;
      else if (isnan(f)) u = 0x7fc00000u;
      else u = (unsigned int)__float_as_int(f);
      u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
      return (unsigned long long)u;
    }
    case TY_LONG: return (unsigned long long)v.i ^ 0x8000000000000000ULL;
    case TY_BOOL: return (unsigned long long)(v.i != 0);
    default: return (unsigned long long)((unsigned int)(int)v.i ^ 0x80000000u);
  }
}

// promotion casts (never narrowing): int/id/bool and long to float, int to long
__device__ __forceinline__ Val cast_up(Val v, int from, int to) {
  Val r;
  if (to == TY_FLOAT) {
    if (from == TY_FLOAT) return v;
    r.f = from == TY_LONG ? __ll2float_rn(v.i) : __int2float_rn((int)v.i);
  } else if (to == TY_INT) {
    r.i = (int)v.i;
  } else {
    r.i = v.i;
  }
  return r;
}

__device__ __forceinline__ int t_int_div(int a, int b) {
  if (b == 0) return -1;
  if (a == (int)0x80000000 && b == -1) return a;
  return a / b;
}
__device__ __forceinline__ int t_int_rem(int a, int b) {
  if (b == 0) return a;
  if (a == (int)0x80000000 && b == -1) return 0;
  return a % b;
}
__device__ __forceinline__ long long t_ll_div(long long a, long long b) {
  if (b == 0) return -1;
  if (a == (long long)0x8000000000000000ULL && b == -1) return a;
  return a / b;
}
__device__ __forceinline__ long long t_ll_rem(long long a, long long b) {
  if (b == 0) return a;
  if (a == (long long)0x8000000000000000ULL && b == -1) return 0;
  return a % b;
}

__device__ __forceinline__ Val t_arith(int op, Val a, Val b, int t) {
  Val r;
  r.i = 0;
  if (t == TY_FLOAT) {
    switch (op) {
      case 0: r.f = xla_add(a.f, b.f); break;
      case 1: r.f = xla_sub(a.f, b.f); break;
      case 2: r.f = xla_mul(a.f, b.f); break;
      case 3: r.f = xla_div(a.f, b.f); break;
      case 4: r.f = xla_mod(a.f, b.f); break;
      // % by a constant power of two >= 1 (core/pattern.py ARITH_MOD_POW2):
      // XLA's arithmetic rewrite reads a subnormal dividend as zero too
      default: r.f = xla_mod(flush_subnormal(a.f), b.f); break;
    }
  } else if (t == TY_INT) {
    const unsigned int x = (unsigned int)(int)a.i, y = (unsigned int)(int)b.i;
    int v;
    switch (op) {
      case 0: v = (int)(x + y); break;
      case 1: v = (int)(x - y); break;
      case 2: v = (int)(x * y); break;
      case 3: v = t_int_div((int)x, (int)y); break;
      default: v = t_int_rem((int)x, (int)y); break;
    }
    r.i = v;
  } else {
    const unsigned long long x = (unsigned long long)a.i, y = (unsigned long long)b.i;
    switch (op) {
      case 0: r.i = (long long)(x + y); break;
      case 1: r.i = (long long)(x - y); break;
      case 2: r.i = (long long)(x * y); break;
      case 3: r.i = t_ll_div(a.i, b.i); break;
      default: r.i = t_ll_rem(a.i, b.i); break;
    }
  }
  return r;
}

template <typename X>
__device__ __forceinline__ bool t_cmp(int op, X a, X b) {
  switch (op) {
    case 0: return a < b;
    case 1: return a <= b;
    case 2: return a > b;
    case 3: return a >= b;
    case 4: return a == b;
    default: return a != b;
  }
}

// One program (len instructions at ins) on what `src` reads: src.reg(ins)
// is the OP_REG instruction's row register, src.operand(ins) the
// OP_OPERAND instruction's value (a capture, a table lane).
template <class Src>
__device__ Val run_prog(const long long* ins, int len, const Src& src) {
  Val st[kMaxStack];
  int sp = 0;
  for (int i = 0; i < len; ++i, ins += 5) {
    switch ((int)ins[0]) {
      case OP_REG:
        st[sp++] = src.reg(ins);
        break;
      case OP_CONST: {
        Val v;
        v.i = ins[2];
        if (ins[1] == TY_FLOAT) v.f = __int_as_float((int)ins[2]);
        st[sp++] = v;
        break;
      }
      case OP_OPERAND:
        st[sp++] = src.operand(ins);
        break;
      case OP_ARITH: {
        const int t_out = (int)ins[4];
        const Val y = cast_up(st[sp - 1], (int)ins[3], t_out);
        const Val x = cast_up(st[sp - 2], (int)ins[2], t_out);
        --sp;
        st[sp - 1] = t_arith((int)ins[1], x, y, t_out);
        break;
      }
      case OP_CMP: {
        const int lt = (int)ins[2], rt = (int)ins[3], tc = (int)ins[4], op = (int)ins[1];
        const Val y = st[sp - 1], x = st[sp - 2];
        bool v = not_null(x, lt) && not_null(y, rt);
        if (tc == TY_FLOAT) {
          v = v && t_cmp(op, flush_subnormal(cast_up(x, lt, TY_FLOAT).f),
                         flush_subnormal(cast_up(y, rt, TY_FLOAT).f));
        } else if (tc == TY_INT) {
          v = v && t_cmp(op, (int)x.i, (int)y.i);
        } else {
          v = v && t_cmp(op, x.i, y.i);
        }
        --sp;
        st[sp - 1].i = v;
        break;
      }
      case OP_AND:
        --sp;
        st[sp - 1].i = st[sp - 1].i && st[sp].i;
        break;
      case OP_OR:
        --sp;
        st[sp - 1].i = st[sp - 1].i || st[sp].i;
        break;
      case OP_NOT:
        st[sp - 1].i = !st[sp - 1].i;
        break;
      default:  // OP_ISNULL
        st[sp - 1].i = !not_null(st[sp - 1], (int)ins[1]);
        break;
    }
  }
  return st[0];
}

// registers at row b, table lanes read from their arrays at slot c
struct RowSlot {
  const LaneSet* regs;
  const LaneSet* lanes;
  long long b, c;
  __device__ Val reg(const long long* ins) const {
    return load_elem(regs->p[ins[1]], b, regs->ty[ins[1]]);
  }
  __device__ Val operand(const long long* ins) const {
    return load_elem(lanes->p[ins[1]], c, lanes->ty[ins[1]]);
  }
};

// registers at row b, table lanes from a thread-local copy of one slot
struct RowLocal {
  const LaneSet* regs;
  const Val* lv;
  long long b;
  __device__ Val reg(const long long* ins) const {
    return load_elem(regs->p[ins[1]], b, regs->ty[ins[1]]);
  }
  __device__ Val operand(const long long* ins) const { return lv[ins[1]]; }
};

// a block's copy of `len` instructions (shared memory, 5 words each)
__device__ __forceinline__ void load_code(const long long* code, int words, long long* s_code) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) s_code[i] = code[i];
  __syncthreads();
}

}  // namespace
