"""Elliptic-curve point arithmetic (Jacobian, a = 0 curves) in plain PyTorch.

Counterpart of `sirius_tpu/curves/jpoint.py::Curve`, with the same formulas
(dbl-2009-l, the complete select-based add, madd-2007-bl), so Jacobian
outputs match the JAX package bit for bit.  A point batch is a `Points`
tuple of three (..., 8) Montgomery word tensors; z == 0 is the identity,
encoded (0, one, 0).

Independent field multiplies are stacked into one call, as in the JAX
package: every `Field.mul` call costs the same one kernel launch on the card
(~150 tensor operations on the CPU) whatever its width.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..fields import gold
from ..fields.constants import CurveSpec
from ..fields.jfield import WORDS, Field, field_for
from ..util.device import resolve


class Points(NamedTuple):
    """Batch of Jacobian points; z == 0 <=> identity."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def shape(self):
        return self.x.shape[:-1]

    @property
    def device(self):
        return self.x.device


def _st(*xs):
    return torch.stack(torch.broadcast_tensors(*xs))


class Curve:
    """Curve context: base-field ops + curve constants."""

    def __init__(self, spec: CurveSpec):
        if spec.a != 0:
            raise ValueError("only a=0 short Weierstrass curves are supported")
        self.spec = spec
        self.fb: Field = field_for(spec.base)
        self.fs: Field = field_for(spec.scalar)

    @property
    def limbs(self) -> Curve:
        """This curve over `Field.limbs`: the limb arithmetic on every device,
        what the kernels' plain twins run."""
        return _LIMB_CURVES[self.spec.name]

    def __hash__(self):
        return hash(self.spec.name)

    def __eq__(self, other):
        return isinstance(other, Curve) and self.spec.name == other.spec.name

    def __repr__(self):
        return f"Curve({self.spec.name})"

    # -- constructors / host conversion -------------------------------------------
    def identity(self, shape=(), device=None) -> Points:
        f = self.fb
        device = resolve(device)
        return Points(f.zeros(shape, device), f.ones(shape, device), f.zeros(shape, device))

    def encode(self, pts: Sequence[gold.AffinePoint], device=None) -> Points:
        f = self.fb
        device = resolve(device)
        xs = [0 if p.is_identity else p.x for p in pts]
        ys = [1 if p.is_identity else p.y for p in pts]
        zs = [0 if p.is_identity else 1 for p in pts]
        return Points(f.encode(xs, device), f.encode(ys, device), f.encode(zs, device))

    def decode(self, P: Points) -> list[gold.AffinePoint]:
        """Jacobian batch -> host affine points (C order)."""
        f = self.fb
        n = P.x.reshape(-1, WORDS).shape[0]
        vals = f.decode(torch.stack([c.reshape(-1, WORDS) for c in P]))
        xs, ys, zs = vals[:n], vals[n : 2 * n], vals[2 * n :]
        out = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                out.append(gold.identity(self.spec))
            else:
                zi = gold.inv_mod(z, f.p)
                out.append(gold.AffinePoint(self.spec, x * zi * zi % f.p, y * zi * zi * zi % f.p))
        return out

    # -- predicates ------------------------------------------------------------------
    def is_identity(self, P: Points):
        return self.fb.is_zero(P.z)

    def select(self, cond, P: Points, Q: Points) -> Points:
        f = self.fb
        return Points(f.select(cond, P.x, Q.x), f.select(cond, P.y, Q.y), f.select(cond, P.z, Q.z))

    def neg(self, P: Points) -> Points:
        return Points(P.x, self.fb.neg(P.y), P.z)

    # -- group law -------------------------------------------------------------------
    def dbl(self, P: Points) -> Points:
        """Jacobian doubling, a = 0 (dbl-2009-l); identity-safe (z3 = 2*y*z)."""
        f = self.fb
        A, B = f.square(_st(P.x, P.y))
        C, T = f.square(_st(B, f.add(P.x, B)))
        D = f.double(f.sub(f.sub(T, A), C))
        E = f.add(f.double(A), A)
        F = f.square(E)
        X3 = f.sub(F, f.double(D))
        u, v = f.mul(_st(E, P.y), _st(f.sub(D, X3), P.z))
        Y3 = f.sub(u, f.double(f.double(f.double(C))))
        return Points(X3, Y3, f.double(v))

    def add(self, P: Points, Q: Points) -> Points:
        """Complete Jacobian addition: the general formula, then selects over
        identity operands, doubling and inverse pairs."""
        f = self.fb
        z1z1, z2z2 = f.square(_st(P.z, Q.z))
        u1, u2, t1, t2 = f.mul(_st(P.x, Q.x, P.y, Q.y), _st(z2z2, z1z1, Q.z, P.z))
        s1, s2 = f.mul(_st(t1, t2), _st(z2z2, z1z1))
        h = f.sub(u2, u1)
        r = f.sub(s2, s1)
        hh, r2 = f.square(_st(h, r))
        hhh, v, zz = f.mul(_st(h, u1, P.z), _st(hh, hh, Q.z))
        x3 = f.sub(f.sub(r2, hhh), f.double(v))
        a, b, z3 = f.mul(_st(r, s1, zz), _st(f.sub(v, x3), hhh, h))
        out = Points(x3, f.sub(a, b), z3)

        p_inf = self.is_identity(P)
        q_inf = self.is_identity(Q)
        h_zero = f.is_zero(h)
        r_zero = f.is_zero(r)
        dbl_case = h_zero & r_zero & ~p_inf & ~q_inf
        inf_case = h_zero & ~r_zero & ~p_inf & ~q_inf
        Pb = Points(*(c.expand_as(x3) for c in P))
        Qb = Points(*(c.expand_as(x3) for c in Q))
        out = self.select(dbl_case, self.dbl(Pb), out)
        out = self.select(inf_case, self.identity(out.shape, x3.device), out)
        out = self.select(q_inf, Pb, out)
        return self.select(p_inf, Qb, out)

    def add_mixed_fast(self, P: Points, qx, qy) -> Points:
        """Incomplete mixed addition (madd-2007-bl): Q = (qx, qy) affine, not
        the identity, and Q != +-P for non-identity P; P may be the identity.
        The commitment-key contract (distinct hash-to-curve generators)."""
        f = self.fb
        z1z1 = f.square(P.z)
        u2, t = f.mul(_st(qx, qy), _st(z1z1, P.z))
        s2 = f.mul(t, z1z1)
        h = f.sub(u2, P.x)
        rr = f.double(f.sub(s2, P.y))
        hh, r2, zh2 = f.square(_st(h, rr, f.add(P.z, h)))
        i4 = f.double(f.double(hh))
        j, v = f.mul(_st(h, P.x), _st(i4, i4))
        x3 = f.sub(f.sub(r2, j), f.double(v))
        a, b = f.mul(_st(rr, P.y), _st(f.sub(v, x3), j))
        y3 = f.sub(a, f.double(b))
        z3 = f.sub(f.sub(zh2, z1z1), hh)
        p_inf = self.is_identity(P)
        one = f.ones(x3.shape[:-1], x3.device)
        return Points(f.select(p_inf, qx.expand_as(x3), x3),
                      f.select(p_inf, qy.expand_as(x3), y3),
                      f.select(p_inf, one, z3))

    # -- helpers -----------------------------------------------------------------------
    def scalar_mul(self, P: Points, k: int) -> Points:
        """Double-and-add by a host scalar (for tests)."""
        acc = self.identity(P.shape, P.device)
        base = P
        while k:
            if k & 1:
                acc = self.add(acc, base)
            base = self.dbl(base)
            k >>= 1
        return acc

    def sum_reduce(self, P: Points, axis: int = 0) -> Points:
        """Log-depth point sum along `axis`."""
        P = Points(*(c.movedim(axis, 0) for c in P))
        if P.x.shape[0] == 0:
            return self.identity(P.x.shape[1:-1], P.device)
        while P.x.shape[0] > 1:
            n = P.x.shape[0]
            half = n // 2
            s = self.add(Points(*(c[:half] for c in P)), Points(*(c[half : 2 * half] for c in P)))
            P = Points(*(torch.cat([a, c[2 * half :]], 0) for a, c in zip(s, P))) if n % 2 else s
        return Points(*(c[0] for c in P))


from ..fields.constants import bn256_g1, grumpkin, pallas, vesta  # noqa: E402

BN256_G1 = Curve(bn256_g1)
GRUMPKIN = Curve(grumpkin)
PALLAS = Curve(pallas)
VESTA = Curve(vesta)

_CURVES = {c.spec.name: c for c in (BN256_G1, GRUMPKIN, PALLAS, VESTA)}


def _over_limbs(curve: Curve) -> Curve:
    out = Curve(curve.spec)
    out.fb, out.fs = curve.fb.limbs, curve.fs.limbs
    return out


_LIMB_CURVES = {name: _over_limbs(c) for name, c in _CURVES.items()}


def curve_for(spec: CurveSpec) -> Curve:
    return _CURVES[spec.name]
