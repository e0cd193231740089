"""Limbed Montgomery field arithmetic in plain PyTorch.

Counterpart of `sirius_tpu/fields/jfield.py::Field`.

Representation
--------------
A batch of field elements is an `int64[..., 8]` tensor of little-endian
32-bit words (each word in [0, 2^32)), in Montgomery form with R = 2^256 and
canonical (value < p).  This is exactly the JAX package's encoding with
pairs of its 16-bit limbs packed into one word, so values cross between the
two packages without arithmetic (`util/interop.py`).

Why int64 containers: PyTorch on the CPU implements neither `+` nor the
shifts for uint32, and int64 leaves headroom for lazy carries.

The multiply works over 16-bit limbs in a limb-first (33, N) int64
accumulator: round i adds b's limbs times a's limb i (products < 2^32) and
then m_i * p, for 16 Montgomery rounds.  A column collects
at most 32 products plus carries (< 2^38), so no carry is rippled inside
the rounds; one signed 8-word ripple picks the canonical result at the end.

That limb arithmetic is the ring ops' CPU path.  On CUDA tensors each ring
op (add, sub, neg, double, mul, square) is one launch of a hand-written
kernel over 8x32-bit words (`ops/field_kernels.ring_op`: `addsub_rows`,
`mul_rows`), the same words; `Field.limbs` runs the limb arithmetic on any
device, for the kernels' plain twins.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..util.device import resolve
from .constants import FieldSpec

WORDS = 8
M32 = 0xFFFFFFFF
M16 = 0xFFFF
R_BITS = 256
CPU_MUL_CHUNK = 4096


def ints_to_words(xs: Sequence[int]) -> np.ndarray:
    """Host ints in [0, 2^256) -> (n, 8) int64 little-endian 32-bit words."""
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(buf, dtype="<u4").astype(np.int64).reshape(len(xs), WORDS)


def words_to_ints(arr) -> list[int]:
    """(..., 8) words (tensor or array) -> flat list of ints (C order)."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr).reshape(-1, WORDS).astype("<u4"))
    buf = a.tobytes()
    return [int.from_bytes(buf[32 * i : 32 * (i + 1)], "little") for i in range(a.shape[0])]


def _words_of(x: int) -> list[int]:
    return [(x >> (32 * k)) & M32 for k in range(WORDS)]


def _ripple(cols: list[torch.Tensor]):
    """Carry-propagate lazy words (any sign) into 32-bit words; returns the
    words and the signed carry out of the top word."""
    out, c = [], 0
    for col in cols:
        v = col + c
        out.append(v & M32)
        c = v >> 32  # arithmetic shift: a borrow is -1
    return out, c


class Field:
    """Per-prime arithmetic context.  Stateless apart from a per-device cache
    of constant tensors; hashable by field name."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.modulus
        self.p_words = _words_of(self.p)
        self.n0inv16 = spec.n0_inv  # -p^-1 mod 2^16 (CIOS over 16-bit limbs)
        self.n0inv32 = (-pow(self.p, -1, 1 << 32)) % (1 << 32)  # for the CUDA CIOS
        self.r_mod_p = spec.r_mod_p
        self.one_mont_words = _words_of(spec.r_mod_p)
        self.r2 = spec.r2_mod_p
        self._consts: dict = {}

    def __hash__(self):
        return hash(self.spec.name)

    def __eq__(self, other):
        return isinstance(other, Field) and self.spec.name == other.spec.name

    def __repr__(self):
        return f"Field({self.spec.name})"

    # -- constants ---------------------------------------------------------------
    def _c(self, name: str, device) -> torch.Tensor:
        key = (name, str(torch.device(device)))
        t = self._consts.get(key)
        if t is None:
            if name == "p16":  # (16, 1) limb column of p
                t = torch.tensor([(self.p >> (16 * j)) & M16 for j in range(16)],
                                 dtype=torch.int64).reshape(16, 1)
            elif name == "p":
                t = torch.tensor(self.p_words, dtype=torch.int64)
            elif name == "r2":
                t = torch.tensor(_words_of(self.r2), dtype=torch.int64)
            elif name == "one_std":
                t = torch.tensor(_words_of(1), dtype=torch.int64)
            elif name == "one_mont":
                t = torch.tensor(self.one_mont_words, dtype=torch.int64)
            elif name == "zero":
                t = torch.zeros(WORDS, dtype=torch.int64)
            else:
                raise KeyError(name)
            t = t.to(device)
            self._consts[key] = t
        return t

    # -- host conversions --------------------------------------------------------
    def encode(self, xs: Sequence[int] | int, device=None) -> torch.Tensor:
        """Host ints -> Montgomery words; an int gives shape (8,), a sequence
        (n, 8).  `device` None means the CUDA device (util/device.py)."""
        device = resolve(device)
        if isinstance(xs, int):
            return torch.from_numpy(ints_to_words([(xs % self.p) * (1 << R_BITS) % self.p])[0]).to(device)
        arr = ints_to_words([(x % self.p) * (1 << R_BITS) % self.p for x in xs])
        return torch.from_numpy(arr).to(device)

    def decode(self, t: torch.Tensor) -> list[int]:
        """Montgomery words (..., 8) -> list of ints (C order)."""
        return [v % self.p for v in words_to_ints(self.from_mont(t))]

    def decode_one(self, t: torch.Tensor) -> int:
        return self.decode(t.reshape(-1, WORDS))[0]

    def zeros(self, shape=(), device=None) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (WORDS,), dtype=torch.int64, device=resolve(device))

    def ones(self, shape=(), device=None) -> torch.Tensor:
        return self._c("one_mont", resolve(device)).expand(tuple(shape) + (WORDS,)).clone()

    def const(self, x: int, shape=(), device=None) -> torch.Tensor:
        """Constant int -> Montgomery words broadcast to shape (a view)."""
        return self.encode(x % self.p, device).expand(tuple(shape) + (WORDS,))

    # -- ring ops (Montgomery in, Montgomery out; broadcasting) ------------------
    def _canon(self, lo, hi):
        """Pick the canonical one of two lazy word tensors whose values are
        V and V + p (lo, hi) with V in (-p, p): one signed ripple over both,
        then V if V >= 0 else V + p."""
        both = torch.stack(torch.broadcast_tensors(lo, hi))
        out, c = _ripple(list(both.unbind(-1)))
        out = torch.stack(out, -1)
        return torch.where((c[0] >= 0).unsqueeze(-1), out[0], out[1])

    def add(self, a, b):
        if a.is_cuda or b.is_cuda:
            return _ring_op(self, "add", a, b)
        return self.add_limbs(a, b)

    def sub(self, a, b):
        if a.is_cuda or b.is_cuda:
            return _ring_op(self, "sub", a, b)
        return self.sub_limbs(a, b)

    def neg(self, a):
        if a.is_cuda:
            return _ring_op(self, "sub", self._c("zero", a.device), a)
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p."""
        if a.is_cuda or b.is_cuda:
            return _ring_op(self, "mul", a, b)
        return self.mul_limbs(a, b)

    @property
    def limbs(self) -> Field:
        """This field with every ring op on the limb arithmetic, on any device:
        what the kernels' plain twins run."""
        return _limb_field(self.spec)

    def add_limbs(self, a, b):
        s = a + b
        return self._canon(s - self._c("p", s.device), s)

    def sub_limbs(self, a, b):
        d = a - b
        return self._canon(d, d + self._c("p", d.device))

    def mul_limbs(self, a, b):
        """Montgomery product a*b*R^-1 mod p (CIOS, lazy carries).  On the CPU
        in chunks of CPU_MUL_CHUNK elements, whose accumulator stays in cache
        (2-3x faster at 2^17 elements than one pass)."""
        shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        a = a.expand(shape + (WORDS,)).reshape(-1, WORDS)
        b = b.expand(shape + (WORDS,)).reshape(-1, WORDS)
        n = a.shape[0]
        if n == 0:
            return torch.zeros(shape + (WORDS,), dtype=torch.int64, device=a.device)
        if a.device.type == "cpu" and n > CPU_MUL_CHUNK:
            out = torch.cat([self._mul_flat(a[i : i + CPU_MUL_CHUNK], b[i : i + CPU_MUL_CHUNK])
                             for i in range(0, n, CPU_MUL_CHUNK)])
        else:
            out = self._mul_flat(a, b)
        return out.reshape(shape + (WORDS,))

    def _mul_flat(self, a, b):
        """(n, 8) x (n, 8) -> (n, 8) Montgomery products."""
        n = a.shape[0]
        dev = a.device

        def limbs(w):  # (n, 8) words -> (16, n) limb-first 16-bit limbs
            return torch.stack([w & M16, w >> 16], -1).reshape(n, 16).t().contiguous()

        al, bl = limbs(a), limbs(b)
        # schoolbook rows inside 16 Montgomery rounds: column i is whole once
        # a's limb i is in, so m_i is read from it; the (33, n) accumulator is
        # the only table, which bounds a call's memory
        t = torch.zeros(33, n, dtype=torch.int64, device=dev)
        p16 = self._c("p16", dev)
        for i in range(16):
            t[i : i + 16].addcmul_(bl, al[i])
            ti = t[i]
            m = (ti * self.n0inv16) & M16
            t[i : i + 16].addcmul_(p16, m)
            t[i + 1] += ti >> 16
        res = t[16:32]
        lazy = (res[0::2] + (res[1::2] << 16)).t()  # (n, 8) lazy words, value < 2p
        return self._canon(lazy - self._c("p", dev), lazy)

    def square(self, a):
        return self.mul(a, a)

    # -- Montgomery domain -------------------------------------------------------
    def to_mont(self, a_std):
        """Standard-form words (any value < 2^256) -> Montgomery (mod p)."""
        return self.mul(a_std, self._c("r2", a_std.device))

    def to_mont_words(self, words: torch.Tensor) -> torch.Tensor:
        """Packed standard-form (n, 8) u32 words (an int32 tensor holding the
        u32 bits, or int64 words) -> Montgomery (n, 8) int64 words: the
        product by R^2, one `mul_rows` launch at K = 1 with b = R^2
        broadcast (its plain version for CPU tensors)."""
        from ..ops.field_kernels import mul_rows

        w = words.to(torch.int64) & M32
        return mul_rows(self, w, self._c("r2", w.device)[None])

    def from_mont(self, a_mont):
        return self.mul(a_mont, self._c("one_std", a_mont.device))

    # -- predicates --------------------------------------------------------------
    @staticmethod
    def is_zero(a):
        return (a == 0).all(-1)

    @staticmethod
    def eq(a, b):
        return (a == b).all(-1)

    @staticmethod
    def select(cond, x, y):
        return torch.where(cond.unsqueeze(-1), x, y)

    # -- exponentiation / inversion ----------------------------------------------
    def pow_int(self, a, e: int):
        """a^e for a host exponent (left-to-right square and multiply)."""
        if e < 0:
            raise ValueError("negative exponent")
        if e == 0:
            return self.ones(a.shape[:-1], a.device)
        acc = a
        for bit in bin(e)[3:]:
            acc = self.square(acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Fermat inverse a^(p-2); inv(0) = 0."""
        return self.pow_int(a, self.p - 2)

    def _scan_mul(self, a, reverse: bool = False):
        """Inclusive prefix (or suffix) products along axis 0, log depth."""
        if reverse:
            return self._scan_mul(a.flip(0)).flip(0)
        out = a
        s = 1
        while s < out.shape[0]:
            out = torch.cat([out[:s], self.mul(out[s:], out[:-s])], 0)
            s *= 2
        return out

    def batch_inv(self, a, axis: int = 0):
        """Montgomery batch inversion along `axis`; zeros map to zeros."""
        a = a.movedim(axis, 0)
        nz = ~self.is_zero(a)
        one = self.ones(a.shape[1:-1], a.device)
        a1 = self.select(nz, a, one.expand_as(a))
        prefix = self._scan_mul(a1)
        suffix = self._scan_mul(a1, reverse=True)
        total_inv = self.inv(prefix[-1])
        p_prev = torch.cat([one[None], prefix[:-1]], 0)
        s_next = torch.cat([suffix[1:], one[None]], 0)
        out = self.mul(self.mul(p_prev, s_next), total_inv)
        out = self.select(nz, out, torch.zeros_like(out))
        return out.movedim(0, axis)

    def sum_reduce(self, a, axis: int = 0):
        """Log-depth modular sum along `axis`."""
        a = a.movedim(axis, 0)
        if a.shape[0] == 0:
            return self.zeros(a.shape[1:-1], a.device)
        while a.shape[0] > 1:
            n = a.shape[0]
            half = n // 2
            s = self.add(a[:half], a[half : 2 * half])
            a = torch.cat([s, a[2 * half :]], 0) if n % 2 else s
        return a[0]

    def random(self, shape, rng: np.random.Generator | None = None, device=None) -> torch.Tensor:
        """Uniform elements from a numpy generator (the same draws as the JAX
        package's `Field.random`, so both give the same values)."""
        rng = rng or np.random.default_rng()
        total = int(np.prod(shape)) if shape else 1
        vals = [
            int(rng.integers(0, 2**63)) | (int(rng.integers(0, 2**63)) << 63)
            | (int(rng.integers(0, 2**63)) << 126) | (int(rng.integers(0, 2**63)) << 189)
            for _ in range(total)
        ]
        return self.encode([v % self.p for v in vals], device).reshape(tuple(shape) + (WORDS,))


class LimbField(Field):
    """A field whose ring ops run the limb arithmetic on every device
    (`Field.limbs`)."""

    add, sub, mul = Field.add_limbs, Field.sub_limbs, Field.mul_limbs

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    @property
    def limbs(self) -> Field:
        return self


def _ring_op(field: Field, op: str, a, b):
    from ..ops.field_kernels import ring_op

    return ring_op(field, op, a, b)


from .constants import bn256_fq, bn256_fr, pasta_fp, pasta_fq  # noqa: E402

FQ = Field(bn256_fq)
FR = Field(bn256_fr)
PASTA_FP = Field(pasta_fp)
PASTA_FQ = Field(pasta_fq)

_FIELDS = {f.spec.name: f for f in (FQ, FR, PASTA_FP, PASTA_FQ)}
_LIMB_FIELDS = {name: LimbField(f.spec) for name, f in _FIELDS.items()}


def _limb_field(spec: FieldSpec) -> LimbField:
    return _LIMB_FIELDS[spec.name]


def field_for(spec: FieldSpec) -> Field:
    return _FIELDS[spec.name]
