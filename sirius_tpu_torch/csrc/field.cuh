// Montgomery field arithmetic over 8 x 32-bit little-endian words (R = 2^256).
//
// Device counterpart of `sirius_tpu/ops/limb_kernels.py::KF` (add, sub, mul)
// and of the port's plain `fields/jfield.py::Field`.  Every result is fully
// reduced below p, so encodings match the JAX package and the plain torch
// twin word for word.
//
// The multiply is CIOS with 32x32->64-bit limb products in
// `unsigned long long` and every carry taken to the next word explicitly:
// the JAX package's lazy-carry trick relies on 16-bit limbs in 32-bit lanes
// and does not carry over to 32-bit limbs.  n0inv is -p^-1 mod 2^32 (the
// JAX package's is mod 2^16).
//
// Storage at the kernel boundary is the port's tensor layout: (n, 8) int64,
// one 32-bit word per element; kernels read the low 32 bits and write words
// back zero-extended.

#pragma once

#include <cstdint>

struct FieldConst {
  uint32_t p[8];
  uint32_t one[8];  // R mod p: the Montgomery form of 1
  uint32_t n0inv;   // -p^-1 mod 2^32
};

// Host-side constructor from the 17-word array the Python wrapper passes.
inline FieldConst make_field_const(const uint32_t* w) {
  FieldConst fc;
  for (int k = 0; k < 8; ++k) {
    fc.p[k] = w[k];
    fc.one[k] = w[8 + k];
  }
  fc.n0inv = w[16];
  return fc;
}

struct Fe {
  uint32_t v[8];
};

__device__ __forceinline__ Fe fe_load(const long long* src, long long row) {
  Fe r;
  const long long* s = src + row * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = (uint32_t)s[k];
  return r;
}

__device__ __forceinline__ void fe_store(long long* dst, long long row, const Fe& a) {
  long long* d = dst + row * 8;
#pragma unroll
  for (int k = 0; k < 8; ++k) d[k] = (long long)a.v[k];
}

// Bits [w c, w c + c) of a 256-bit scalar held as eight words in int64 (a
// c-bit window, c < 32, as `ops/madd.py:extract_digits` takes it).
__device__ __forceinline__ uint32_t window_digit(const long long* s, int w, int c) {
  const int bit = w * c, word = bit >> 5, off = bit & 31;
  uint32_t d = (uint32_t)s[word] >> off;
  if (off + c > 32 && word + 1 < 8) d |= (uint32_t)s[word + 1] << (32 - off);
  return d & ((1u << c) - 1u);
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = 0u;
  return r;
}

__device__ __forceinline__ Fe fe_one(const FieldConst& fc) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = fc.one[k];
  return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
  uint32_t acc = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) acc |= a.v[k];
  return acc == 0u;
}

__device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = c ? a.v[k] : b.v[k];
  return r;
}

// a (with carry word hi) < 2p  ->  a mod p
__device__ __forceinline__ Fe fe_reduce_once(const Fe& a, uint32_t hi, const FieldConst& fc) {
  Fe d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    unsigned long long t = (unsigned long long)a.v[k] - (unsigned long long)fc.p[k] - borrow;
    d.v[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);  // 1 iff the difference went negative
  }
  // keep a only when it is below p: no carry word and a borrow out
  return fe_select(hi == 0u && borrow == 1u, a, d);
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const FieldConst& fc) {
  Fe s;
  unsigned long long c = 0ull;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += (unsigned long long)a.v[k] + b.v[k];
    s.v[k] = (uint32_t)c;
    c >>= 32;
  }
  return fe_reduce_once(s, (uint32_t)c, fc);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const FieldConst& fc) {
  Fe d;
  uint32_t borrow = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    unsigned long long t = (unsigned long long)a.v[k] - (unsigned long long)b.v[k] - borrow;
    d.v[k] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  // a < b: add p back, dropping the carry out (the sum wraps mod 2^256)
  Fe e;
  unsigned long long c = 0ull;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    c += (unsigned long long)d.v[k] + fc.p[k];
    e.v[k] = (uint32_t)c;
    c >>= 32;
  }
  return fe_select(borrow == 1u, e, d);
}

__device__ __forceinline__ Fe fe_double(const Fe& a, const FieldConst& fc) {
  return fe_add(a, a, fc);
}

// One CIOS round: t += a * bi, then t = (t + m * p) / 2^32 with m chosen so
// the low word vanishes.
__device__ __forceinline__ void cios_round(uint32_t* t, const Fe& a, uint32_t bi, const FieldConst& fc) {
  unsigned long long c = 0ull;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    unsigned long long s = (unsigned long long)a.v[j] * bi + t[j] + c;
    t[j] = (uint32_t)s;
    c = s >> 32;
  }
  unsigned long long s8 = (unsigned long long)t[8] + c;
  t[8] = (uint32_t)s8;
  t[9] = (uint32_t)(s8 >> 32);
  uint32_t m = t[0] * fc.n0inv;
  unsigned long long s0 = (unsigned long long)m * fc.p[0] + t[0];
  c = s0 >> 32;
#pragma unroll
  for (int j = 1; j < 8; ++j) {
    unsigned long long s = (unsigned long long)m * fc.p[j] + t[j] + c;
    t[j - 1] = (uint32_t)s;
    c = s >> 32;
  }
  unsigned long long s9 = (unsigned long long)t[8] + c;
  t[7] = (uint32_t)s9;
  t[8] = t[9] + (uint32_t)(s9 >> 32);
  t[9] = 0u;
}

// CIOS Montgomery product a*b*R^-1 mod p.  ROLLED (the TPU's
// `KF(roll_mul=True)`: mul_rows' `rolled` product, and fe_mul_n's form off
// the device) runs the eight rounds as a loop that is not unrolled: b's
// words rotate by one per round, so every round reads word 0 and b stays in
// registers (the TPU variant rolls its limb array the same way).  The
// default, unrolled, is mul_rows' `unrolled` product.
template <bool ROLLED>
__device__ __forceinline__ Fe fe_mul_t(const Fe& a, const Fe& b, const FieldConst& fc) {
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) t[k] = 0u;
  if (ROLLED) {
    Fe r = b;
#pragma unroll 1
    for (int i = 0; i < 8; ++i) {
      cios_round(t, a, r.v[0], fc);
#pragma unroll
      for (int k = 0; k < 7; ++k) r.v[k] = r.v[k + 1];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) cios_round(t, a, b.v[i], fc);
  }
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; ++k) r.v[k] = t[k];
  return fe_reduce_once(r, t[8], fc);
}

__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b, const FieldConst& fc) {
  return fe_mul_t<false>(a, b, fc);
}

// ---- carry-chain arithmetic (B1, B2, B3 through fe_mul_n, B4) ----------------
//
// fe_add_cc, fe_sub_cc and fe_mul_cc compute fe_add, fe_sub and fe_mul word
// for word, with every carry in a PTX carry chain on the device (add.cc /
// addc, sub.cc / subc, mad.lo.cc / madc.hi.cc: the carry stays in the flag
// instead of in a 64-bit sum that is split again), the standard form of
// 256-bit Montgomery arithmetic on NVIDIA GPUs.  A chain lives inside one
// asm statement: the flag does not survive between statements.  The product
// is CIOS: per round 8 + 8 multiply-adds for a * b_i, one for m, 7 + 8 for
// m * p (the low word of t_0 + m p_0 is 0 by the choice of m, so only its
// carry, t_0 != 0, is taken), 256 in all where the hand count of 32x32->64
// products is 136.  It needs 2p < 2^256 (every field of the port has
// p < 2^254): a round's sum t + a b_i + m p < 2^288 fits in nine words.
// Without __CUDA_ARCH__ (a host rehearsal) they are the C++ functions above.

#ifdef __CUDA_ARCH__
// s (with carry word c) < 2p -> s mod p
__device__ __forceinline__ Fe fe_reduce_cc(const Fe& s, uint32_t c, const FieldConst& fc) {
  Fe d = s;
  uint32_t bw = c;
  asm("sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32 %8, %8, 0;"
      : "+r"(d.v[0]), "+r"(d.v[1]), "+r"(d.v[2]), "+r"(d.v[3]), "+r"(d.v[4]), "+r"(d.v[5]), "+r"(d.v[6]),
        "+r"(d.v[7]), "+r"(bw)
      : "r"(fc.p[0]), "r"(fc.p[1]), "r"(fc.p[2]), "r"(fc.p[3]), "r"(fc.p[4]), "r"(fc.p[5]), "r"(fc.p[6]),
        "r"(fc.p[7]));
  // bw = c - borrow: all ones exactly when there is no carry word and s < p
  return fe_select(bw == 0xFFFFFFFFu, s, d);
}

__device__ __forceinline__ Fe fe_add_cc(const Fe& a, const Fe& b, const FieldConst& fc) {
  Fe s = a;
  uint32_t c = 0u;
  asm("add.cc.u32 %0, %0, %9;\n\t"
      "addc.cc.u32 %1, %1, %10;\n\t"
      "addc.cc.u32 %2, %2, %11;\n\t"
      "addc.cc.u32 %3, %3, %12;\n\t"
      "addc.cc.u32 %4, %4, %13;\n\t"
      "addc.cc.u32 %5, %5, %14;\n\t"
      "addc.cc.u32 %6, %6, %15;\n\t"
      "addc.cc.u32 %7, %7, %16;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(s.v[0]), "+r"(s.v[1]), "+r"(s.v[2]), "+r"(s.v[3]), "+r"(s.v[4]), "+r"(s.v[5]), "+r"(s.v[6]),
        "+r"(s.v[7]), "+r"(c)
      : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  return fe_reduce_cc(s, c, fc);
}

__device__ __forceinline__ Fe fe_sub_cc(const Fe& a, const Fe& b, const FieldConst& fc) {
  Fe d = a;
  uint32_t bw = 0u;
  asm("sub.cc.u32 %0, %0, %9;\n\t"
      "subc.cc.u32 %1, %1, %10;\n\t"
      "subc.cc.u32 %2, %2, %11;\n\t"
      "subc.cc.u32 %3, %3, %12;\n\t"
      "subc.cc.u32 %4, %4, %13;\n\t"
      "subc.cc.u32 %5, %5, %14;\n\t"
      "subc.cc.u32 %6, %6, %15;\n\t"
      "subc.cc.u32 %7, %7, %16;\n\t"
      "subc.u32 %8, %8, 0;"
      : "+r"(d.v[0]), "+r"(d.v[1]), "+r"(d.v[2]), "+r"(d.v[3]), "+r"(d.v[4]), "+r"(d.v[5]), "+r"(d.v[6]),
        "+r"(d.v[7]), "+r"(bw)
      : "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]), "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]),
        "r"(b.v[7]));
  // a < b: add p back, dropping the carry out (the sum wraps mod 2^256)
  Fe e = d;
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;"
      : "+r"(e.v[0]), "+r"(e.v[1]), "+r"(e.v[2]), "+r"(e.v[3]), "+r"(e.v[4]), "+r"(e.v[5]), "+r"(e.v[6]),
        "+r"(e.v[7])
      : "r"(fc.p[0]), "r"(fc.p[1]), "r"(fc.p[2]), "r"(fc.p[3]), "r"(fc.p[4]), "r"(fc.p[5]), "r"(fc.p[6]),
        "r"(fc.p[7]));
  return fe_select(bw != 0u, e, d);
}

// One CIOS round of fe_mul_cc on t (nine words): t += a * bi, then t += m p
// with m = t_0 * n0inv and t /= 2^32.
__device__ __forceinline__ void cc_round(uint32_t (&t)[9], const Fe& a, uint32_t bi, const FieldConst& fc) {
  t[8] = 0u;
  // t (< 2p, eight words) += a * b_i into nine words
  asm("mad.lo.cc.u32 %0, %9, %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32 %8, %16, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8])
      : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]), "r"(a.v[6]), "r"(a.v[7]),
        "r"(bi));
  // t += m * p with m = t_0 * n0inv, so the low word vanishes: its carry is
  // t_0 != 0, which t_0 + (2^32 - 1) carries too
  const uint32_t m = t[0] * fc.n0inv;
  asm("add.cc.u32 %0, %0, 0xFFFFFFFF;\n\t"
      "madc.lo.cc.u32 %1, %9, %11, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.lo.cc.u32 %3, %9, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %9, %14, %4;\n\t"
      "madc.lo.cc.u32 %5, %9, %15, %5;\n\t"
      "madc.lo.cc.u32 %6, %9, %16, %6;\n\t"
      "madc.lo.cc.u32 %7, %9, %17, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      "mad.hi.cc.u32 %1, %9, %10, %1;\n\t"
      "madc.hi.cc.u32 %2, %9, %11, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.hi.cc.u32 %4, %9, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %9, %14, %5;\n\t"
      "madc.hi.cc.u32 %6, %9, %15, %6;\n\t"
      "madc.hi.cc.u32 %7, %9, %16, %7;\n\t"
      "madc.hi.u32 %8, %9, %17, %8;"
      : "+r"(t[0]), "+r"(t[1]), "+r"(t[2]), "+r"(t[3]), "+r"(t[4]), "+r"(t[5]), "+r"(t[6]), "+r"(t[7]),
        "+r"(t[8])
      : "r"(m), "r"(fc.p[0]), "r"(fc.p[1]), "r"(fc.p[2]), "r"(fc.p[3]), "r"(fc.p[4]), "r"(fc.p[5]), "r"(fc.p[6]),
        "r"(fc.p[7]));
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = t[k + 1];  // divide by 2^32
}

__device__ __forceinline__ Fe fe_mul_cc(const Fe& a, const Fe& b, const FieldConst& fc) {
  uint32_t t[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) t[k] = 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) cc_round(t, a, b.v[i], fc);
  const Fe w = {{t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7]}};
  return fe_reduce_cc(w, 0u, fc);
}
#else
__device__ __forceinline__ Fe fe_add_cc(const Fe& a, const Fe& b, const FieldConst& fc) { return fe_add(a, b, fc); }
__device__ __forceinline__ Fe fe_sub_cc(const Fe& a, const Fe& b, const FieldConst& fc) { return fe_sub(a, b, fc); }
__device__ __forceinline__ Fe fe_mul_cc(const Fe& a, const Fe& b, const FieldConst& fc) {
  return fe_mul_t<false>(a, b, fc);
}
#endif

__device__ __forceinline__ Fe fe_double_cc(const Fe& a, const FieldConst& fc) { return fe_add_cc(a, a, fc); }

// A field element of a read-only (n, 8) int64 array whose rows are 16-byte
// aligned, in four 16-byte non-coherent loads (ld.global.nc.v2).
__device__ __forceinline__ Fe fe_load_ro(const long long* src, long long row) {
#ifdef __CUDA_ARCH__
  Fe r;
  const longlong2* s = reinterpret_cast<const longlong2*>(src + row * 8);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const longlong2 w = __ldg(s + k);
    r.v[2 * k] = (uint32_t)w.x;
    r.v[2 * k + 1] = (uint32_t)w.y;
  }
  return r;
#else
  return fe_load(src, row);
#endif
}

// A field element into an (n, 8) int64 array whose rows are 16-byte
// aligned, in four 16-byte stores (st.global.v2), zero-extended words.
__device__ __forceinline__ void fe_store_v(long long* dst, long long row, const Fe& a) {
#ifdef __CUDA_ARCH__
  longlong2* d = reinterpret_cast<longlong2*>(dst + row * 8);
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = make_longlong2((long long)a.v[2 * k], (long long)a.v[2 * k + 1]);
#else
  fe_store(dst, row, a);
#endif
}

// N independent rolled carry-chain products r[n] = a[n] * b[n] * R^-1
// (B3's and S1's, through pt_add_ilp and pt_dbl_ilp): cc_round's
// CIOS rounds, interleaved over the N products in one rolled loop, b's
// words rotating by one per round so every round reads word 0 and b stays
// in registers.  One thread's dependent carry chains overlap N ways, so N
// products cost about one product's latency while the code stays one loop
// body.  The same words as fe_mul; without __CUDA_ARCH__ the C++ rolled
// product fe_mul_t<true>.
template <int N>
__device__ __forceinline__ void fe_mul_n(Fe* r, const Fe* a, const Fe* b, const FieldConst& fc) {
#ifdef __CUDA_ARCH__
  uint32_t t[N][9];
  Fe rb[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    rb[n] = b[n];
#pragma unroll
    for (int k = 0; k < 9; ++k) t[n][k] = 0u;
  }
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      cc_round(t[n], a[n], rb[n].v[0], fc);
#pragma unroll
      for (int k = 0; k < 7; ++k) rb[n].v[k] = rb[n].v[k + 1];
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const Fe w = {{t[n][0], t[n][1], t[n][2], t[n][3], t[n][4], t[n][5], t[n][6], t[n][7]}};
    r[n] = fe_reduce_cc(w, 0u, fc);
  }
#else
  for (int n = 0; n < N; ++n) r[n] = fe_mul_t<true>(a[n], b[n], fc);
#endif
}


// ---- the wide product (S2's K = 8 chain, B1's batched madd) -----------------
//
// fe_mul_wide computes fe_mul's words (CIOS, fully reduced, no lazy
// reduction) with every 32x32->64 product as an adjacent low/high pair in
// one carry chain (mad.lo.cc then madc.hi.cc of the same operands, which
// ptxas can issue as one wide multiply-add with carry).  The words of one
// parity of a times b_i do not overlap (a_2k b_i fills words 2k and
// 2k + 1), so a_even b_i is one chain of four pairs into an accumulator x,
// and a_odd b_i another into y, one word up: the value is x + y 2^32, and
// the two chains are independent.  m p is split the same way, m = x_0
// n0inv.  Then x_0 = 0, and the division by 2^32 swaps the roles: the next
// round adds the old x_1 into the new x's word 0 at the head of the chain
// that shifts the old x down two words as it adds a_odd b_i into it (the
// carry lands in that array's word 0: the same weight, 2^32), so no round
// moves a word.  x's carry out goes into y's top word (the same weight,
// 2^256); y never carries out: y 2^32 <= T + a b_i + m p < 2^33 p, so
// y < 2p (CIOS keeps T < 2p; it needs 2p < 2^256, as fe_mul_cc does).
// After eight rounds the arrays merge (x / 2^32 + y), and one conditional
// subtraction of p finishes.  This is the layout of sppark's ff/mont_t.cuh
// (mul_n, cmad_n, madc_n_rshift, mad_n_redc), the standard 256-bit
// Montgomery product on NVIDIA GPUs.  Each chain is one asm statement on
// the device; without __CUDA_ARCH__ each PTX op is emulated with an explicit
// carry flag, in the same order, so a host rehearsal runs this algorithm's
// own carries, folds and role swaps.

#ifndef __CUDA_ARCH__
// x + y + cf, the carry out into cf (add.cc / addc.cc / mad.lo.cc / madc.*.cc)
__device__ __forceinline__ uint32_t wide_addc(uint32_t x, uint32_t y, uint32_t& cf) {
  const unsigned long long s = (unsigned long long)x + y + cf;
  cf = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
__device__ __forceinline__ uint32_t wide_lo(uint32_t a, uint32_t b) { return a * b; }
__device__ __forceinline__ uint32_t wide_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((unsigned long long)a * b) >> 32);
}
#endif

// d = sum_k w_k b 2^(64 k): four products side by side, no carries.
__device__ __forceinline__ void wide_mul4(uint32_t (&d)[8], const uint32_t (&w)[4], uint32_t b) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned long long s = (unsigned long long)w[k] * b;
    d[2 * k] = (uint32_t)s;
    d[2 * k + 1] = (uint32_t)(s >> 32);
  }
}

// x += sum_k w_k b 2^(64 k), its carry out into top.
__device__ __forceinline__ void wide_mad(uint32_t (&x)[8], uint32_t& top, const uint32_t (&w)[4], uint32_t b) {
#ifdef __CUDA_ARCH__
  asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;"
      : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]), "+r"(x[6]), "+r"(x[7]),
        "+r"(top)
      : "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]), "r"(b));
#else
  uint32_t cf = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = wide_addc(wide_lo(w[k], b), x[2 * k], cf);
    x[2 * k + 1] = wide_addc(wide_hi(w[k], b), x[2 * k + 1], cf);
  }
  top = wide_addc(top, 0u, cf);
#endif
}

// y += sum_k w_k b 2^(64 k), which never carries out (y < 2p throughout).
__device__ __forceinline__ void wide_mad_nc(uint32_t (&y)[8], const uint32_t (&w)[4], uint32_t b) {
#ifdef __CUDA_ARCH__
  asm("mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
      "madc.hi.u32 %7, %11, %12, %7;"
      : "+r"(y[0]), "+r"(y[1]), "+r"(y[2]), "+r"(y[3]), "+r"(y[4]), "+r"(y[5]), "+r"(y[6]), "+r"(y[7])
      : "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]), "r"(b));
#else
  uint32_t cf = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    y[2 * k] = wide_addc(wide_lo(w[k], b), y[2 * k], cf);
    y[2 * k + 1] = wide_addc(wide_hi(w[k], b), y[2 * k + 1], cf);
  }
#endif
}

// The division by 2^32 and the next a_odd b_i in one chain: x_0 += y_1,
// its carry into the shifted y, y = y / 2^64 + sum_k w_k b 2^(64 k) (y_0 is
// 0 here: it was the reduced array; y_1 went into x_0).
__device__ __forceinline__ void wide_fold_shift(uint32_t& x0, uint32_t (&y)[8], const uint32_t (&w)[4], uint32_t b) {
#ifdef __CUDA_ARCH__
  asm("add.cc.u32 %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
      "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
      "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
      "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
      "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
      "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
      "madc.hi.u32 %8, %12, %13, 0;"
      : "+r"(x0), "+r"(y[0]), "+r"(y[1]), "+r"(y[2]), "+r"(y[3]), "+r"(y[4]), "+r"(y[5]), "+r"(y[6]), "+r"(y[7])
      : "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3]), "r"(b));
#else
  uint32_t cf = 0u;
  x0 = wide_addc(x0, y[1], cf);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    y[2 * k] = wide_addc(wide_lo(w[k], b), y[2 * k + 2], cf);
    y[2 * k + 1] = wide_addc(wide_hi(w[k], b), y[2 * k + 3], cf);
  }
  y[6] = wide_addc(wide_lo(w[3], b), 0u, cf);
  y[7] = wide_addc(wide_hi(w[3], b), 0u, cf);
#endif
}

// The merge after the last round: y += x / 2^32 (x_0 is 0), below 2p.
__device__ __forceinline__ void wide_merge(uint32_t (&y)[8], const uint32_t (&x)[8]) {
#ifdef __CUDA_ARCH__
  asm("add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, 0;"
      : "+r"(y[0]), "+r"(y[1]), "+r"(y[2]), "+r"(y[3]), "+r"(y[4]), "+r"(y[5]), "+r"(y[6]), "+r"(y[7])
      : "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]), "r"(x[6]), "r"(x[7]));
#else
  uint32_t cf = 0u;
#pragma unroll
  for (int k = 0; k < 7; ++k) y[k] = wide_addc(y[k], x[k + 1], cf);
  y[7] = wide_addc(y[7], 0u, cf);
#endif
}

// One round on the pair (x at weight 1, y at 2^32): first (round 0) sets
// x = a_even b_i, y = a_odd b_i; every later one folds and shifts; then
// m = x_0 n0inv and x + y 2^32 += m p, after which x_0 = 0.
__device__ __forceinline__ void wide_round(uint32_t (&x)[8], uint32_t (&y)[8], const uint32_t (&ae)[4],
                                           const uint32_t (&ao)[4], uint32_t bi, const uint32_t (&pe)[4],
                                           const uint32_t (&po)[4], uint32_t n0inv, bool first) {
  if (first) {
    wide_mul4(y, ao, bi);
    wide_mul4(x, ae, bi);
  } else {
    wide_fold_shift(x[0], y, ao, bi);
    wide_mad(x, y[7], ae, bi);
  }
  const uint32_t m = x[0] * n0inv;
  wide_mad_nc(y, po, m);
  wide_mad(x, y[7], pe, m);
}

// N independent wide products r[n] = a[n] * b[n] * R^-1 mod p, their
// rounds interleaved (B1's dependency levels): fe_mul's words.
template <int N>
__device__ __forceinline__ void fe_mul_wide_n(Fe* r, const Fe* a, const Fe* b, const FieldConst& fc) {
  const uint32_t pe[4] = {fc.p[0], fc.p[2], fc.p[4], fc.p[6]};
  const uint32_t po[4] = {fc.p[1], fc.p[3], fc.p[5], fc.p[7]};
  uint32_t e[N][8], o[N][8], ae[N][4], ao[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ae[n][k] = a[n].v[2 * k];
      ao[n][k] = a[n].v[2 * k + 1];
    }
  }
  // rounds of even i run on (e, o), of odd i on (o, e): the roles swap
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (i % 2 == 0)
        wide_round(e[n], o[n], ae[n], ao[n], b[n].v[i], pe, po, fc.n0inv, i == 0);
      else
        wide_round(o[n], e[n], ae[n], ao[n], b[n].v[i], pe, po, fc.n0inv, false);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    wide_merge(e[n], o[n]);  // round 7 ran on (o, e): the value is o / 2^32 + e
    const Fe w = {{e[n][0], e[n][1], e[n][2], e[n][3], e[n][4], e[n][5], e[n][6], e[n][7]}};
#ifdef __CUDA_ARCH__
    r[n] = fe_reduce_cc(w, 0u, fc);
#else
    r[n] = fe_reduce_once(w, 0u, fc);
#endif
  }
}

__device__ __forceinline__ Fe fe_mul_wide(const Fe& a, const Fe& b, const FieldConst& fc) {
  Fe r;
  fe_mul_wide_n<1>(&r, &a, &b, fc);
  return r;
}
