// Witness-tape interpreter: straight-line bignum program replay.
//
// The port's own copy of `sirius_tpu/native/witness_tape.cpp`.  Executes the
// op stream recorded by `frontend/tape.py` (trace-once / replay-native
// witness synthesis, the counterpart of the reference's native Rust witness
// collectors, `src/table/witness_collector.rs`).  Host C++, not a device
// kernel: it runs on the CPU beside the card, once per fold step.
// Semantics mirror Python ints exactly: arbitrary precision (bounded at
// 16x64-bit magnitude by the tracer's range analysis), floor division,
// sign-preserving shifts, non-negative %.  `TapeBuilder._replay_py` is its
// plain version.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (see native/__init__.py);
// exposed via ctypes.  Returns 0, or 1 overflow, 2 bad opcode, 3 bad
// modulus, 4 negative operand of a bit op, 5 output not in [0, 2^256).

#include <cstdint>
#include <cstring>

using u64 = uint64_t;
using u128 = unsigned __int128;

static const int LIMBS = 16;  // 1024-bit magnitude

struct Big {
  int32_t neg;  // 1 if negative (mag != 0), else 0
  int32_t len;  // number of significant limbs (0 => value 0)
  u64 mag[LIMBS];
};

static inline void set_zero(Big &x) { x.neg = 0; x.len = 0; }

static inline void norm(Big &x) {
  while (x.len > 0 && x.mag[x.len - 1] == 0) x.len--;
  if (x.len == 0) x.neg = 0;
}

static inline int ucmp(const Big &a, const Big &b) {
  if (a.len != b.len) return a.len < b.len ? -1 : 1;
  for (int i = a.len - 1; i >= 0; i--)
    if (a.mag[i] != b.mag[i]) return a.mag[i] < b.mag[i] ? -1 : 1;
  return 0;
}

// |r| = |a| + |b|; returns 1 on overflow
static inline int uadd(Big &r, const Big &a, const Big &b) {
  int n = a.len > b.len ? a.len : b.len;
  u64 carry = 0;
  for (int i = 0; i < n; i++) {
    u128 s = (u128)(i < a.len ? a.mag[i] : 0) + (i < b.len ? b.mag[i] : 0) + carry;
    r.mag[i] = (u64)s;
    carry = (u64)(s >> 64);
  }
  if (carry) {
    if (n >= LIMBS) return 1;
    r.mag[n++] = carry;
  }
  r.len = n;
  return 0;
}

// |r| = |a| - |b|, requires |a| >= |b|
static inline void usub(Big &r, const Big &a, const Big &b) {
  u64 borrow = 0;
  for (int i = 0; i < a.len; i++) {
    u64 bv = i < b.len ? b.mag[i] : 0;
    u64 av = a.mag[i];
    u64 d = av - bv - borrow;
    borrow = (av < bv + (u128)borrow) ? 1 : 0;
    r.mag[i] = d;
  }
  r.len = a.len;
  norm(r);
}

// r = a + b (signed); returns nonzero on overflow
static int sadd(Big &r, const Big &a, const Big &b) {
  if (a.neg == b.neg) {
    if (uadd(r, a, b)) return 1;
    r.neg = a.len || b.len ? a.neg : 0;
    norm(r);
    return 0;
  }
  int c = ucmp(a, b);
  if (c == 0) { set_zero(r); return 0; }
  if (c > 0) { usub(r, a, b); r.neg = a.neg; }
  else       { usub(r, b, a); r.neg = b.neg; }
  norm(r);
  return 0;
}

static int ssub(Big &r, const Big &a, const Big &b) {
  Big nb = b;
  if (nb.len) nb.neg ^= 1;
  return sadd(r, a, nb);
}

// r = a * b; returns nonzero on overflow (product > 16 limbs)
static int smul(Big &r, const Big &a, const Big &b) {
  if (a.len == 0 || b.len == 0) { set_zero(r); return 0; }
  if (a.len + b.len > LIMBS + 1) return 1;
  u64 tmp[2 * LIMBS] = {0};
  for (int i = 0; i < a.len; i++) {
    u64 carry = 0;
    u64 ai = a.mag[i];
    for (int j = 0; j < b.len; j++) {
      u128 s = (u128)ai * b.mag[j] + tmp[i + j] + carry;
      tmp[i + j] = (u64)s;
      carry = (u64)(s >> 64);
    }
    tmp[i + b.len] += carry;
  }
  int n = a.len + b.len;
  while (n > 0 && tmp[n - 1] == 0) n--;
  if (n > LIMBS) return 1;
  for (int i = 0; i < n; i++) r.mag[i] = tmp[i];
  r.len = n;
  r.neg = (a.neg != b.neg) ? 1 : 0;
  if (r.len == 0) r.neg = 0;
  return 0;
}

static inline int nlz(u64 x) { return x ? __builtin_clzll(x) : 64; }

// |q|, |rem| = divmod(|a|, |b|) — Knuth algorithm D. b != 0.
static void udivmod(const Big &a, const Big &b, Big &q, Big &rem) {
  if (ucmp(a, b) < 0) { set_zero(q); rem = a; rem.neg = 0; return; }
  if (b.len == 1) {
    u64 d = b.mag[0];
    u128 r = 0;
    q.len = a.len;
    for (int i = a.len - 1; i >= 0; i--) {
      u128 cur = (r << 64) | a.mag[i];
      q.mag[i] = (u64)(cur / d);
      r = cur % d;
    }
    q.neg = 0; norm(q);
    rem.len = r ? 1 : 0; rem.mag[0] = (u64)r; rem.neg = 0;
    return;
  }
  // normalize
  int sh = nlz(b.mag[b.len - 1]);
  u64 un[LIMBS + 2], vn[LIMBS];
  int n = b.len, m = a.len;
  for (int i = n - 1; i > 0; i--)
    vn[i] = sh ? (b.mag[i] << sh) | (b.mag[i - 1] >> (64 - sh)) : b.mag[i];
  vn[0] = b.mag[0] << sh;
  un[m] = sh ? a.mag[m - 1] >> (64 - sh) : 0;
  for (int i = m - 1; i > 0; i--)
    un[i] = sh ? (a.mag[i] << sh) | (a.mag[i - 1] >> (64 - sh)) : a.mag[i];
  un[0] = a.mag[0] << sh;

  set_zero(q);
  for (int j = m - n; j >= 0; j--) {
    u128 cur = ((u128)un[j + n] << 64) | un[j + n - 1];
    u128 qhat = cur / vn[n - 1];
    u128 rhat = cur % vn[n - 1];
    while (qhat >= ((u128)1 << 64) ||
           (u128)qhat * vn[n - 2] > ((rhat << 64) | un[j + n - 2])) {
      qhat--;
      rhat += vn[n - 1];
      if (rhat >= ((u128)1 << 64)) break;
    }
    // multiply-subtract
    u128 borrow = 0, carry = 0;
    for (int i = 0; i < n; i++) {
      u128 p = (u128)(u64)qhat * vn[i] + carry;
      carry = p >> 64;
      u64 pl = (u64)p;
      u64 before = un[i + j];
      u64 after = before - pl - (u64)borrow;
      borrow = ((u128)pl + (u64)borrow > before) ? 1 : 0;
      un[i + j] = after;
    }
    u64 before = un[j + n];
    u64 sub = (u64)carry + (u64)borrow;
    un[j + n] = before - sub;
    if (before < sub) {
      // qhat was one too big: add back
      qhat--;
      u128 c2 = 0;
      for (int i = 0; i < n; i++) {
        u128 s = (u128)un[i + j] + vn[i] + c2;
        un[i + j] = (u64)s;
        c2 = s >> 64;
      }
      un[j + n] += (u64)c2;
    }
    q.mag[j] = (u64)qhat;
  }
  q.len = m - n + 1;
  q.neg = 0;
  norm(q);
  for (int i = 0; i < n; i++)
    rem.mag[i] = sh ? (un[i] >> sh) | ((i + 1 < n ? un[i + 1] : un[n]) << (64 - sh))
                    : un[i];
  rem.len = n;
  rem.neg = 0;
  norm(rem);
}

// Python divmod: q = floor(a/b), r = a - q*b (0 <= r < b for b > 0)
static void pydivmod(const Big &a, const Big &b, Big &q, Big &r) {
  udivmod(a, b, q, r);
  if (a.neg && r.len) {
    // a negative: floor shifts down one
    Big one; one.neg = 0; one.len = 1; one.mag[0] = 1;
    Big q2; uadd(q2, q, one); q2.neg = 0; q = q2; q.neg = 1; norm(q);
    Big r2; usub(r2, b, r); r = r2; r.neg = 0; norm(r);
  } else if (a.neg) {
    q.neg = q.len ? 1 : 0;
  }
}

// x >>= k (floor semantics handled by caller); magnitude shift right
static void ushr(Big &r, const Big &a, int k) {
  int drop = k / 64, sh = k % 64;
  if (drop >= a.len) { set_zero(r); return; }
  int n = a.len - drop;
  for (int i = 0; i < n; i++) {
    u64 lo = a.mag[i + drop] >> sh;
    u64 hi = (sh && i + drop + 1 < a.len) ? a.mag[i + drop + 1] << (64 - sh) : 0;
    r.mag[i] = lo | hi;
  }
  r.len = n;
  norm(r);
}

static int ushl(Big &r, const Big &a, int k) {
  if (a.len == 0) { set_zero(r); return 0; }
  int add = k / 64, sh = k % 64;
  int n = a.len + add + (sh ? 1 : 0);
  if (n > LIMBS) return 1;
  for (int i = n - 1; i >= 0; i--) {
    int src = i - add;
    u64 hi = (src >= 0 && src < a.len) ? a.mag[src] << sh : 0;
    u64 lo = (sh && src - 1 >= 0 && src - 1 < a.len) ? a.mag[src - 1] >> (64 - sh) : 0;
    r.mag[i] = hi | lo;
  }
  r.len = n;
  norm(r);
  return 0;
}

// out = a^-1 mod m (m odd, a reduced nonzero): binary extended gcd
static void inv_mod(Big &out, const Big &a, const Big &m) {
  Big u = a, v = m, x1, x2;
  x1.neg = 0; x1.len = 1; x1.mag[0] = 1;
  set_zero(x2);
  auto is_one = [](const Big &x) { return x.len == 1 && x.mag[0] == 1; };
  auto halve_mod = [&](Big &x) {
    if (x.mag[0] & 1) { Big t; uadd(t, x, m); t.neg = 0; ushr(x, t, 1); }
    else { Big t; ushr(t, x, 1); x = t; }
  };
  while (!is_one(u) && !is_one(v)) {
    while (u.len && !(u.mag[0] & 1)) { Big t; ushr(t, u, 1); u = t; halve_mod(x1); }
    while (v.len && !(v.mag[0] & 1)) { Big t; ushr(t, v, 1); v = t; halve_mod(x2); }
    if (ucmp(u, v) >= 0) {
      Big t; usub(t, u, v); u = t;
      if (ucmp(x1, x2) >= 0) { Big s; usub(s, x1, x2); x1 = s; }
      else { Big s; uadd(s, x1, m); Big s2; usub(s2, s, x2); x1 = s2; }
    } else {
      Big t; usub(t, v, u); v = t;
      if (ucmp(x2, x1) >= 0) { Big s; usub(s, x2, x1); x2 = s; }
      else { Big s; uadd(s, x2, m); Big s2; usub(s2, s, x1); x2 = s2; }
    }
  }
  out = is_one(u) ? x1 : x2;
  out.neg = 0;
  norm(out);
  if (ucmp(out, m) >= 0) { Big t; usub(t, out, m); out = t; }
}

// opcodes — keep in sync with frontend/tape.py
enum {
  OP_CONST = 0, OP_ADD = 1, OP_SUB = 2, OP_MUL = 3, OP_MODC = 4, OP_DIVC = 5,
  OP_SHR = 6, OP_SHL = 7, OP_AND = 8, OP_BIT = 9, OP_INV0 = 10, OP_ISZERO = 11,
  OP_POWM = 12, OP_XOR = 13,
};

extern "C" int sirius_tape_replay(
    const uint8_t *code, const uint32_t *aa, const uint32_t *bb, const uint32_t *cc,
    int64_t n_ops, int64_t n_inputs,
    const uint8_t *inputs,        // n_inputs x 32 bytes LE
    const uint8_t *const_mags,    // n_consts x 128 bytes LE magnitude
    const uint8_t *const_negs,    // n_consts bytes
    int64_t n_consts,
    const uint32_t *out_slots, int64_t n_out,
    uint8_t *out)                 // n_out x 32 bytes
{
  int64_t n_slots = n_inputs + n_ops;
  Big *s = new Big[n_slots];
  for (int64_t i = 0; i < n_inputs; i++) {
    Big &x = s[i];
    x.neg = 0;
    std::memcpy(x.mag, inputs + i * 32, 32);
    for (int j = 4; j < LIMBS; j++) x.mag[j] = 0;
    x.len = 4;
    norm(x);
  }
  int err = 0;
  for (int64_t i = 0; i < n_ops && !err; i++) {
    Big &r = s[n_inputs + i];
    uint32_t a = aa[i], b = bb[i], c = cc[i];
    switch (code[i]) {
      case OP_CONST: {
        std::memcpy(r.mag, const_mags + (int64_t)b * 128, 128);
        r.len = LIMBS;
        r.neg = const_negs[b];
        norm(r);
        break;
      }
      case OP_ADD: err = sadd(r, s[a], s[b]); break;
      case OP_SUB: err = ssub(r, s[a], s[b]); break;
      case OP_MUL: err = smul(r, s[a], s[b]); break;
      case OP_MODC: {
        if (!s[b].len || s[b].neg) { err = 3; break; }
        Big q;
        pydivmod(s[a], s[b], q, r);
        break;
      }
      case OP_DIVC: {
        if (!s[b].len || s[b].neg) { err = 3; break; }
        Big rem;
        pydivmod(s[a], s[b], r, rem);
        break;
      }
      case OP_SHR: {
        if (!s[a].neg) { ushr(r, s[a], (int)b); r.neg = 0; }
        else {
          // floor: -ceil(mag >> k)
          Big t; ushr(t, s[a], (int)b);
          Big chk; ushl(chk, t, (int)b);
          if (ucmp(chk, s[a]) != 0) {
            Big one; one.neg = 0; one.len = 1; one.mag[0] = 1;
            Big t2; uadd(t2, t, one); t = t2;
          }
          r = t;
          r.neg = r.len ? 1 : 0;
        }
        break;
      }
      case OP_SHL: {
        err = ushl(r, s[a], (int)b);
        r.neg = (s[a].neg && r.len) ? 1 : 0;
        break;
      }
      case OP_AND: {
        if (s[a].neg) { err = 4; break; }
        const Big &x = s[a], &m = s[b];
        int n = x.len < m.len ? x.len : m.len;
        for (int j = 0; j < n; j++) r.mag[j] = x.mag[j] & m.mag[j];
        r.len = n;
        r.neg = 0;
        norm(r);
        break;
      }
      case OP_BIT: {
        if (s[a].neg) { err = 4; break; }
        int limb = b / 64, sh = b % 64;
        u64 v = limb < s[a].len ? (s[a].mag[limb] >> sh) & 1 : 0;
        r.neg = 0; r.len = v ? 1 : 0; r.mag[0] = v;
        break;
      }
      case OP_INV0: {
        Big q, red;
        if (!s[b].len || s[b].neg) { err = 3; break; }
        pydivmod(s[a], s[b], q, red);
        if (!red.len) { set_zero(r); break; }
        inv_mod(r, red, s[b]);
        break;
      }
      case OP_ISZERO: {
        r.neg = 0;
        r.len = s[a].len ? 0 : 1;
        r.mag[0] = 1;
        break;
      }
      case OP_POWM: {
        const Big &m = s[c];
        if (!m.len || m.neg) { err = 3; break; }
        Big base, q;
        pydivmod(s[a], m, q, base);
        Big acc; acc.neg = 0; acc.len = 1; acc.mag[0] = 1;
        Big qq, rr;
        pydivmod(acc, m, qq, rr); acc = rr;  // handle m == 1
        uint32_t e = b;
        while (e) {
          if (e & 1) {
            Big t;
            if (smul(t, acc, base)) { err = 1; break; }
            pydivmod(t, m, qq, acc);
          }
          e >>= 1;
          if (e) {
            Big t;
            if (smul(t, base, base)) { err = 1; break; }
            pydivmod(t, m, qq, base);
          }
        }
        r = acc;
        break;
      }
      case OP_XOR: {
        if (s[a].neg || s[b].neg) { err = 4; break; }
        const Big &x = s[a], &y = s[b];
        int n = x.len > y.len ? x.len : y.len;
        for (int j = 0; j < n; j++)
          r.mag[j] = (j < x.len ? x.mag[j] : 0) ^ (j < y.len ? y.mag[j] : 0);
        r.len = n;
        r.neg = 0;
        norm(r);
        break;
      }
      default:
        err = 2;
    }
  }
  if (!err) {
    for (int64_t j = 0; j < n_out; j++) {
      const Big &v = s[out_slots[j]];
      if (v.neg || v.len > 4) { err = 5; break; }
      std::memcpy(out + j * 32, v.mag, 32);
      // zero any tail beyond len
      for (int t = v.len; t < 4; t++)
        std::memset(out + j * 32 + t * 8, 0, 8);
    }
  }
  delete[] s;
  return err;
}
