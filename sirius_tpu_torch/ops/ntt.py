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

`fft_sharded` transforms a vector cut by rows over a mesh (`parallel/`),
the port's counterpart of the JAX package's `_fft` under a `P('rows')`
sharding, where GSPMD inserts the exchanges: here the four-step's two
passes run on every device's own columns, and its transposes are
device-to-device copies.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields import gold
from ..fields.constants import FieldSpec
from ..fields.jfield import WORDS, Field, field_for
from ..parallel.mesh import Mesh, row_blocks, shard_rows
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
        self._peers: dict[torch.device, NTT] = {}
        self._mid_cols: dict[tuple, torch.Tensor] = {}

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
            A = self._pass(A, True, inverse)  # (o1, i2 R)
            B = mul_rows(f, A.reshape(-1, WORDS), T, rep=R)
            D = B.reshape(n1, n2, R, WORDS).transpose(0, 1).reshape(n2, n1 * R, WORDS)
        return self._pass(D, False, inverse).reshape(self.n, R, WORDS)  # (o2, o1 R)

    def _pass(self, a: torch.Tensor, first: bool, inverse: bool) -> torch.Tensor:
        """The unscaled transform along axis 0 of an (n1, R, 8) block (the
        first pass) or an (n2, R, 8) one (the second): B4 `col_ntt`, or a
        nested four-step where the column outgrows one kernel block."""
        size, twiddles = (self.n1, self.inner) if first else (self.n2, self.outer)
        if twiddles is None:
            return self._nest(size)._columns(a, inverse, scaled=False)
        return col_ntt(self.f, a, self.rev_n1 if first else self.rev_n2, twiddles[inverse])

    def _on(self, device: torch.device) -> "NTT":
        """This context's twin on `device` (itself on its own device)."""
        if device == self.device:
            return self
        if device not in self._peers:
            self._peers[device] = NTT(self.f, self.k, device)
        return self._peers[device]

    def _mid_columns(self, inverse: bool, lo: int, hi: int) -> torch.Tensor:
        """Columns [lo, hi) of the (n1, n2) mid twiddle (scaled when
        inverse), as (n1 * (hi - lo), 8) rows, on this context's device."""
        key = (inverse, lo, hi)
        if key not in self._mid_cols:
            T = self.mid_twiddle(inverse).reshape(self.n1, self.n2, WORDS)
            self._mid_cols[key] = T[:, lo:hi].reshape(-1, WORDS).contiguous()
        return self._mid_cols[key]

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

    def fft_sharded(self, blocks: list[torch.Tensor], mesh: Mesh, inverse: bool = False) -> list[torch.Tensor]:
        """The transform of an (n, 8) vector given as its row blocks over
        `mesh` (`parallel.shard_rows(mesh, a)`), returned in the same blocks:
        word for word `shard_rows(mesh, fft(a, inverse))`.

        At k >= FOUR_STEP_MIN_K the four-step runs across the mesh (D
        entries, D dividing n2): with x as the (n1, n2) matrix x[i1, i2],
        block d holds rows i1 of block d; an all-to-all gives device d the
        n2 / D columns of block d, where the first pass (B4 `col_ntt`) and
        the mid twiddle (`mul_rows`, K = 1) run; a second all-to-all gives it
        the rows o1 of block d, transposed, for the second pass; a third
        cuts the output X[o2 * n1 + o1] back into row blocks.  Each
        all-to-all is D x D device-to-device copies (on one device, slices).
        Below FOUR_STEP_MIN_K the blocks are gathered onto the mesh's first
        device, transformed there by the flat route and cut again: a
        transform of fewer than 2^FOUR_STEP_MIN_K elements is one kernel
        launch and not worth three all-to-alls."""
        D, n = mesh.size, self.n
        bounds = row_blocks(n, D)
        if len(blocks) != D:
            raise ValueError(f"{len(blocks)} blocks for a mesh of {D}")
        for b, (lo, hi), dev in zip(blocks, bounds, mesh.devices):
            if b.shape != (hi - lo, WORDS) or b.device != dev:
                raise ValueError(f"block of shape {tuple(b.shape)} on {b.device}, expected ({hi - lo}, {WORDS}) "
                                 f"on {dev}")
        if not self.use_four_step:
            a = torch.cat([b.to(mesh.first) for b in blocks])
            return shard_rows(mesh, self._on(mesh.first).fft(a, inverse))
        n1, n2 = self.n1, self.n2
        if n2 % D:
            raise ValueError(f"the four-step across a mesh of {D} needs D dividing n2 = {n2}")
        r1, c2 = n1 // D, n2 // D  # rows i1 (and o1) per block, columns i2 (and rows o2) per device
        devs = mesh.devices
        rows = [b.reshape(r1, n2, WORDS) for b in blocks]
        out1 = []
        for d, dev in enumerate(devs):  # all-to-all 1: device d gets columns [d c2, (d + 1) c2) of every row
            ctx = self._on(dev)
            A = torch.cat([r[:, d * c2 : (d + 1) * c2].to(dev) for r in rows])  # (n1, c2): x[i1, i2]
            P = ctx._pass(A, True, inverse)  # (o1, i2)
            out1.append(mul_rows(self.f, P.reshape(-1, WORDS), ctx._mid_columns(inverse, d * c2, (d + 1) * c2))
                        .reshape(n1, c2, WORDS))
        out2 = []
        for d, dev in enumerate(devs):  # all-to-all 2: device d gets rows o1 of block d, every column, transposed
            B = torch.cat([o[d * r1 : (d + 1) * r1].to(dev) for o in out1], 1)  # (r1, n2): (o1, i2)
            out2.append(self._on(dev)._pass(B.transpose(0, 1).contiguous(), False, inverse))  # (o2, o1 of block d)
        # all-to-all 3: X[o2 n1 + o1]; block d holds o2 in [d c2, (d + 1) c2), every o1
        return [torch.cat([o[d * c2 : (d + 1) * c2].to(dev) for o in out2], 1).reshape(-1, WORDS)
                for d, dev in enumerate(devs)]

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
