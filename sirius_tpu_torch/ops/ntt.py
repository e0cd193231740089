"""Radix-2 NTT over the port's (n, 8) Montgomery word tensors.

Counterpart of `sirius_tpu/ops/ntt.py`, with its semantics (reference
`src/fft.rs`), bit for bit:
- omega = ROOT_OF_UNITY^(2^(S-k));
- the inverse transform scales by 1/2^k;
- the coset transforms distribute zeta^(i mod 3) (zeta a cube root of
  unity) before the forward and after the inverse transform.

Routes (no switches):
- k >= 10, the four-step (Bailey) transform: n = n1 * n2 with
  n1 = 2^ceil(k/2), n2 = 2^floor(k/2); every element of the column NTT of
  size n1 over n2 columns is multiplied by the mid twiddle
  T[o1, i2] = w^(+-o1*i2) (times 1/n for the inverse), the (n1, n2) block
  is transposed, and pass 2 runs the column NTT of size n2 over n1 columns:
      X[o2*n1 + o1] = sum_i2 w^(n1*i2*o2) T[o1,i2] sum_i1 x[i1*n2 + i2] w^(n2*i1*o1)
  Pass 1, the product by T and the transpose are one launch of B4's
  epilogue variant (`ntt_kernels.col_ntt(..., mid=T)`), so a k <= 24
  transform is two kernel launches.
- k < 10, the flat transform: one column (R = 1) of size n through the same
  kernel, then 1/n for the inverse.
A column pass longer than `ntt_kernels.MAX_SIZE` (what one thread block's
shared memory holds) is itself a four-step over its R columns at once: an
unscaled transform of size s = s1 * s2 along axis 0 of an (s, R) block
runs the two shorter passes around the mid twiddle broadcast over R (B4's
epilogue with rep = R where its first pass fits a kernel column, else the
field product `field_kernels.mul_rows(..., rep=R)` and a transpose).  So
k = 25..28 (columns of 2^13..2^14) run as columns of at most 128.  Every
other elementwise product (coset powers, 1/n) is `mul_rows` with its
factor broadcast over rows, so on a CUDA tensor no plain torch arithmetic
runs; on the CPU every step takes the plain twin, in the same order.  The
route depends on k and MAX_SIZE alone, on every device.

The mid twiddle is built on the device once per direction (and scaling),
by doubling (rows o1 < s times w^(s*i2) give rows s..2s-1), and cached:
that is set-up, `mid_twiddle()` builds it ahead of the first transform.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields import gold
from ..fields.constants import FieldSpec
from ..fields.jfield import WORDS, Field, field_for
from ..util.device import resolve
from . import ntt_kernels
from .field_kernels import mul_rows
from .ntt_kernels import col_ntt

FOUR_STEP_MIN_K = 10


def _bit_reverse_indices(k: int) -> np.ndarray:
    n = 1 << k
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


class NTT:
    """Per-(field, k, device) NTT context with its twiddle tables on the
    device (`device` None: the CUDA device)."""

    def __init__(self, field: Field, k: int, device=None):
        if not 0 <= k <= field.spec.two_adicity:
            raise ValueError(f"k = {k} outside 0..{field.spec.two_adicity} for {field}")
        self.f = field
        self.k = k
        self.n = 1 << k
        self.device = dev = resolve(device)
        self.use_four_step = k >= FOUR_STEP_MIN_K or self.n > ntt_kernels.MAX_SIZE
        p = field.p
        omega = gold.omega_for_k(field.spec, k)
        omega_inv = pow(omega, -1, p)
        zeta = field.spec.zeta

        def powers(base: int, count: int) -> torch.Tensor:
            vals, acc = [], 1
            for _ in range(count):
                vals.append(acc)
                acc = acc * base % p
            return field.encode(vals, dev)  # (count, 8)

        self.n_inv = field.encode([pow(self.n, -1, p)], dev)  # (1, 8)
        self.zeta_pows = powers(zeta, 3)  # row i mod 3: zeta^(i mod 3)
        self.zeta_inv_pows = powers(pow(zeta, -1, p), 3)
        if self.use_four_step:
            self.n1 = 1 << ((k + 1) // 2)
            self.n2 = 1 << (k // 2)
            w_in = pow(omega, self.n2, p)  # order n1
            w_out = pow(omega, self.n1, p)  # order n2
            self.base = {False: powers(omega, self.n2), True: powers(omega_inv, self.n2)}  # w^(+-i2)
            # a pass longer than one kernel column runs through a nested context
            self.inner = self.outer = None
            if self.n1 <= ntt_kernels.MAX_SIZE:
                self.inner = {False: powers(w_in, self.n1 // 2), True: powers(pow(w_in, -1, p), self.n1 // 2)}
                self.rev_n1 = torch.from_numpy(_bit_reverse_indices((k + 1) // 2)).to(dev)
            if self.n2 <= ntt_kernels.MAX_SIZE:
                self.outer = {False: powers(w_out, self.n2 // 2), True: powers(pow(w_out, -1, p), self.n2 // 2)}
                self.rev_n2 = torch.from_numpy(_bit_reverse_indices(k // 2)).to(dev)
            self._nested: dict[int, NTT] = {}
        else:
            half = max(self.n // 2, 1)
            self.table = {False: powers(omega, half), True: powers(omega_inv, half)}
            self.rev = torch.from_numpy(_bit_reverse_indices(k)).to(dev)
        self._mid: dict[tuple[bool, bool], torch.Tensor] = {}

    # -- four-step ------------------------------------------------------------------
    def mid_twiddle(self, inverse: bool = False, scaled: bool | None = None) -> torch.Tensor:
        """(n1 * n2, 8): row o1*n2 + i2 holds w^(+-o1*i2), times 1/n when
        scaled (by default: when inverse); built on the device on first use
        and cached."""
        scaled = inverse if scaled is None else scaled
        T = self._mid.get((inverse, scaled))
        if T is None:
            f, n2 = self.f, self.n2
            rows = self.n_inv.expand(n2, WORDS).contiguous() if scaled else f.ones((n2,), self.device)
            step = self.base[inverse]  # w^(+-s*i2) for the current s
            s = 1
            while s < self.n1:
                rows = torch.cat([rows, mul_rows(f, rows, step)])
                s *= 2
                if s < self.n1:
                    step = mul_rows(f, step, step)
            T = self._mid[(inverse, scaled)] = rows
        return T

    def _nest(self, size: int) -> "NTT":
        if size not in self._nested:
            self._nested[size] = NTT(self.f, size.bit_length() - 1, self.device)
        return self._nested[size]

    def _columns(self, a: torch.Tensor, inverse: bool, scaled: bool) -> torch.Tensor:
        """The transform along axis 0 of an (n, R, 8) block, R columns at once
        (times 1/n when scaled): the four-step with the mid twiddle
        broadcast over R."""
        f, n1, n2 = self.f, self.n1, self.n2
        R = a.shape[1]
        T = self.mid_twiddle(inverse, scaled)
        A = a.reshape(n1, n2 * R, WORDS)
        if self.inner is not None:  # pass 1, times T, transposed: (i2, o1 R)
            D = col_ntt(f, A, self.rev_n1, self.inner[inverse], T, rep=R)
        else:
            A = self._nest(n1)._columns(A, inverse, scaled=False)  # (o1, i2 R)
            B = mul_rows(f, A.reshape(-1, WORDS), T, rep=R)
            D = B.reshape(n1, n2, R, WORDS).transpose(0, 1).reshape(n2, n1 * R, WORDS)
        if self.outer is not None:
            E = col_ntt(f, D, self.rev_n2, self.outer[inverse])  # (o2, o1 R)
        else:
            E = self._nest(n2)._columns(D, inverse, scaled=False)
        return E.reshape(self.n, R, WORDS)

    # -- public API -----------------------------------------------------------------
    def fft(self, a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
        """a: (n, 8) standard or Montgomery words (a linear map either way)."""
        if a.shape != (self.n, WORDS):
            raise ValueError(f"expected ({self.n}, {WORDS}) words, got {tuple(a.shape)}")
        if a.device != self.device:
            raise ValueError(f"input on {a.device}, NTT context on {self.device}")
        if self.use_four_step:
            return self._columns(a.reshape(self.n, 1, WORDS), inverse, inverse).reshape(self.n, WORDS)
        out = col_ntt(self.f, a.reshape(self.n, 1, WORDS), self.rev, self.table[inverse]).reshape(self.n, WORDS)
        return mul_rows(self.f, out, self.n_inv) if inverse else out

    def ifft(self, a: torch.Tensor) -> torch.Tensor:
        return self.fft(a, inverse=True)

    def coset_fft(self, a: torch.Tensor) -> torch.Tensor:
        return self.fft(mul_rows(self.f, a, self.zeta_pows))

    def coset_ifft(self, a: torch.Tensor) -> torch.Tensor:
        return mul_rows(self.f, self.fft(a, inverse=True), self.zeta_inv_pows)


@lru_cache(maxsize=None)
def _ctx(spec: FieldSpec, k: int, device: torch.device) -> NTT:
    return NTT(field_for(spec), k, device)


def ntt_ctx(spec: FieldSpec, k: int, device=None) -> NTT:
    """The cached context of (field, k) on `device` (None: the CUDA device)."""
    return _ctx(spec, k, resolve(device))
