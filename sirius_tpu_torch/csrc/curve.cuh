// Jacobian point arithmetic for a = 0 short Weierstrass curves.
//
// Device counterparts of `sirius_tpu/ops/limb_kernels.py`: `k_dbl`
// (dbl-2009-l), `k_add_complete` (general formula + selects over identity
// operands, doubling and inverse pairs), `k_madd_incomplete` (madd-2007-bl),
// `k_is_zero` and `k_select`.  The formulas are the same step for step, so
// results equal the JAX package's and the plain torch twin's word for word.
// The identity is (0, one, 0); z == 0 marks it everywhere.

#pragma once

#include "field.cuh"

struct Pt {
  Fe x, y, z;
};

__device__ __forceinline__ Pt pt_identity(const FieldConst& fc) {
  Pt r;
  r.x = fe_zero();
  r.y = fe_one(fc);
  r.z = fe_zero();
  return r;
}

__device__ __forceinline__ Pt pt_load(const long long* x, const long long* y, const long long* z, long long row) {
  Pt r;
  r.x = fe_load(x, row);
  r.y = fe_load(y, row);
  r.z = fe_load(z, row);
  return r;
}

__device__ __forceinline__ void pt_store(long long* x, long long* y, long long* z, long long row, const Pt& p) {
  fe_store(x, row, p.x);
  fe_store(y, row, p.y);
  fe_store(z, row, p.z);
}

__device__ __forceinline__ Pt pt_select(bool c, const Pt& a, const Pt& b) {
  Pt r;
  r.x = fe_select(c, a.x, b.x);
  r.y = fe_select(c, a.y, b.y);
  r.z = fe_select(c, a.z, b.z);
  return r;
}

// k_dbl (identity-safe: z3 = 2*y*z) with its products in dependency levels
// (fe_mul_n: the rolled carry-chain product) and the carry-chain adds:
// 3 + 3 + 1 products, so a chain of doublings waits ~3 product latencies per
// doubling instead of 7.
__device__ __forceinline__ Pt pt_dbl_ilp(const Pt& P, const FieldConst& fc) {
  Fe o1[3];
  const Fe a1[3] = {P.x, P.y, P.y}, b1[3] = {P.x, P.y, P.z};
  fe_mul_n<3>(o1, a1, b1, fc);  // A = x^2, B = y^2, y z
  const Fe& A = o1[0];
  const Fe& B = o1[1];
  const Fe xb = fe_add_cc(P.x, B, fc);
  const Fe E = fe_add_cc(fe_double_cc(A, fc), A, fc);
  Fe o2[3];
  const Fe a2[3] = {B, xb, E};
  fe_mul_n<3>(o2, a2, a2, fc);  // C = B^2, T = (x + B)^2, F = E^2
  const Fe& C = o2[0];
  const Fe D = fe_double_cc(fe_sub_cc(fe_sub_cc(o2[1], A, fc), C, fc), fc);
  Pt r;
  r.x = fe_sub_cc(o2[2], fe_double_cc(D, fc), fc);
  const Fe C8 = fe_double_cc(fe_double_cc(fe_double_cc(C, fc), fc), fc);
  Fe o3[1];
  const Fe a3[1] = {E}, b3[1] = {fe_sub_cc(D, r.x, fc)};
  fe_mul_n<1>(o3, a3, b3, fc);
  r.y = fe_sub_cc(o3[0], C8, fc);
  r.z = fe_double_cc(o1[2], fc);
  return r;
}

// k_add_complete (general formula + selects over identity operands,
// doubling and inverse pairs) with its products in dependency levels
// (fe_mul_n) and the carry-chain adds: 5 + 4 + 3 + 2 + 2 products, ~5
// product latencies instead of 16.
__device__ __forceinline__ Pt pt_add_ilp(const Pt& P, const Pt& Q, const FieldConst& fc) {
  Fe o1[5];
  const Fe a1[5] = {P.z, Q.z, P.y, Q.y, P.z}, b1[5] = {P.z, Q.z, Q.z, P.z, Q.z};
  fe_mul_n<5>(o1, a1, b1, fc);  // z1z1, z2z2, y1 z2, y2 z1, z1 z2
  Fe o2[4];
  const Fe a2[4] = {P.x, Q.x, o1[2], o1[3]}, b2[4] = {o1[1], o1[0], o1[1], o1[0]};
  fe_mul_n<4>(o2, a2, b2, fc);  // u1, u2, s1, s2
  const Fe& u1 = o2[0];
  const Fe& s1 = o2[2];
  const Fe h = fe_sub_cc(o2[1], u1, fc);
  const Fe r = fe_sub_cc(o2[3], s1, fc);
  Fe o3[3];
  const Fe a3[3] = {h, r, o1[4]}, b3[3] = {h, r, h};
  fe_mul_n<3>(o3, a3, b3, fc);  // hh, r^2, z3
  Fe o4[2];
  const Fe a4[2] = {h, u1}, b4[2] = {o3[0], o3[0]};
  fe_mul_n<2>(o4, a4, b4, fc);  // hhh, v
  const Fe& hhh = o4[0];
  const Fe& v = o4[1];
  Pt out;
  out.x = fe_sub_cc(fe_sub_cc(o3[1], hhh, fc), fe_double_cc(v, fc), fc);
  Fe o5[2];
  const Fe a5[2] = {r, s1}, b5[2] = {fe_sub_cc(v, out.x, fc), hhh};
  fe_mul_n<2>(o5, a5, b5, fc);
  out.y = fe_sub_cc(o5[0], o5[1], fc);
  out.z = o3[2];

  bool p_inf = fe_is_zero(P.z);
  bool q_inf = fe_is_zero(Q.z);
  bool h_zero = fe_is_zero(h);
  bool r_zero = fe_is_zero(r);
  if (h_zero && r_zero && !p_inf && !q_inf) out = pt_dbl_ilp(P, fc);
  if (h_zero && !r_zero && !p_inf && !q_inf) out = pt_identity(fc);
  if (q_inf) out = P;
  if (p_inf) out = Q;
  return out;
}

// k_madd_incomplete: Q = (qx, qy) affine, not the identity, Q != +-P;
// P may be the identity, which gives Q.  On the carry-chain field ops
// (B1, B2 and the bucket walk): the same words as on fe_add/fe_sub/fe_mul.
__device__ __forceinline__ Pt pt_madd(const Pt& P, const Fe& qx, const Fe& qy, const FieldConst& fc) {
  Fe z1z1 = fe_mul_cc(P.z, P.z, fc);
  Fe u2 = fe_mul_cc(qx, z1z1, fc);
  Fe t = fe_mul_cc(qy, P.z, fc);
  Fe s2 = fe_mul_cc(t, z1z1, fc);
  Fe h = fe_sub_cc(u2, P.x, fc);
  Fe rr = fe_double_cc(fe_sub_cc(s2, P.y, fc), fc);
  Fe hh = fe_mul_cc(h, h, fc);
  Fe zh2 = fe_add_cc(P.z, h, fc);
  zh2 = fe_mul_cc(zh2, zh2, fc);
  Fe r2 = fe_mul_cc(rr, rr, fc);
  Fe i4 = fe_double_cc(fe_double_cc(hh, fc), fc);
  Fe j = fe_mul_cc(h, i4, fc);
  Fe v = fe_mul_cc(P.x, i4, fc);
  Pt out;
  out.x = fe_sub_cc(fe_sub_cc(r2, j, fc), fe_double_cc(v, fc), fc);
  Fe a = fe_mul_cc(rr, fe_sub_cc(v, out.x, fc), fc);
  Fe b = fe_mul_cc(P.y, j, fc);
  out.y = fe_sub_cc(a, fe_double_cc(b, fc), fc);
  out.z = fe_sub_cc(fe_sub_cc(zh2, z1z1, fc), hh, fc);
  if (fe_is_zero(P.z)) {
    out.x = qx;
    out.y = qy;
    out.z = fe_one(fc);
  }
  return out;
}

// k_madd_incomplete as pt_madd computes it (the same words, the same select
// for an identity P), its 11 products in madd-2007-bl's five dependency
// levels on the wide product (fe_mul_wide_n): {z1^2, qy z1}, {u2, s2},
// {h^2, (z1 + h)^2, r^2}, {h I, x1 I}, {r (v - x3), y1 J}, so a thread's
// chains overlap 2-3 ways and the madd waits ~5 product latencies instead
// of 11 (B1's batched madd).
__device__ __forceinline__ Pt pt_madd_wide(const Pt& P, const Fe& qx, const Fe& qy, const FieldConst& fc) {
  Fe o1[2];
  const Fe a1[2] = {P.z, qy}, b1[2] = {P.z, P.z};
  fe_mul_wide_n<2>(o1, a1, b1, fc);  // z1z1, qy z1
  const Fe& z1z1 = o1[0];
  Fe o2[2];
  const Fe a2[2] = {qx, o1[1]}, b2[2] = {z1z1, z1z1};
  fe_mul_wide_n<2>(o2, a2, b2, fc);  // u2, s2
  const Fe h = fe_sub_cc(o2[0], P.x, fc);
  const Fe rr = fe_double_cc(fe_sub_cc(o2[1], P.y, fc), fc);
  Fe o3[3];
  const Fe a3[3] = {h, fe_add_cc(P.z, h, fc), rr};
  fe_mul_wide_n<3>(o3, a3, a3, fc);  // hh, (z1 + h)^2, r^2
  const Fe& hh = o3[0];
  const Fe i4 = fe_double_cc(fe_double_cc(hh, fc), fc);
  Fe o4[2];
  const Fe a4[2] = {h, P.x}, b4[2] = {i4, i4};
  fe_mul_wide_n<2>(o4, a4, b4, fc);  // J = h I, V = x1 I
  const Fe& j = o4[0];
  const Fe& v = o4[1];
  Pt out;
  out.x = fe_sub_cc(fe_sub_cc(o3[2], j, fc), fe_double_cc(v, fc), fc);
  Fe o5[2];
  const Fe a5[2] = {rr, P.y}, b5[2] = {fe_sub_cc(v, out.x, fc), j};
  fe_mul_wide_n<2>(o5, a5, b5, fc);  // r (v - x3), y1 J
  out.y = fe_sub_cc(o5[0], fe_double_cc(o5[1], fc), fc);
  out.z = fe_sub_cc(fe_sub_cc(o3[1], z1z1, fc), hh, fc);
  if (fe_is_zero(P.z)) {
    out.x = qx;
    out.y = qy;
    out.z = fe_one(fc);
  }
  return out;
}
