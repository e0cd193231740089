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

__device__ __forceinline__ Fe fe_neg(const Fe& a, const FieldConst& fc) {
  return fe_sub(fe_zero(), a, fc);
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

// CIOS Montgomery product a*b*R^-1 mod p.  ROLLED (S1's product, the
// TPU's `KF(roll_mul=True)`) runs the eight rounds as a loop that is not
// unrolled: b's words rotate by one per round, so every round reads word 0
// and b stays in registers (the TPU variant rolls its limb array the same
// way).  The default, unrolled, is every other kernel's product.
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

template <bool ROLLED>
__device__ __forceinline__ Fe fe_square_t(const Fe& a, const FieldConst& fc) {
  return fe_mul_t<ROLLED>(a, a, fc);
}

__device__ __forceinline__ Fe fe_square(const Fe& a, const FieldConst& fc) {
  return fe_mul(a, a, fc);
}

// N independent rolled products r[n] = a[n] * b[n] * R^-1, their CIOS rounds
// interleaved in one rolled loop: one thread's dependent carry chains
// (~1,600-2,000 SM cycles per product on the H100) overlap N ways, so N
// products cost about one product's latency while the code stays one loop
// body.  The same words as fe_mul_t.
template <int N>
__device__ __forceinline__ void fe_mul_n(Fe* r, const Fe* a, const Fe* b, const FieldConst& fc) {
  uint32_t t[N][10];
  Fe rb[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    rb[n] = b[n];
#pragma unroll
    for (int k = 0; k < 10; ++k) t[n][k] = 0u;
  }
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      cios_round(t[n], a[n], rb[n].v[0], fc);
#pragma unroll
      for (int k = 0; k < 7; ++k) rb[n].v[k] = rb[n].v[k + 1];
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    Fe w;
#pragma unroll
    for (int k = 0; k < 8; ++k) w.v[k] = t[n][k];
    r[n] = fe_reduce_once(w, t[n][8], fc);
  }
}

