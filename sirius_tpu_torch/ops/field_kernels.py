"""The elementwise field kernels on the card: CUDA wrappers + plain torch twins.

`mul_rows(field, a, b, K=1, rep=1)`: (n, 8) a and (nb, 8) b in Montgomery
form -> a_i * b_((i // rep) mod nb)^K, by K chained Montgomery products, b
broadcast over a's rows with each row repeated rep times.  K = 1 is every
`Field.mul` and `Field.square` on a CUDA tensor (`ring_op`) and the NTT's
elementwise product (coset powers; the flat route's 1/n; the mid twiddle
where a four-step's first pass is itself nested, over R columns at once with
rep = R; the doubling build of the mid twiddle); K = 8 is the field-rate
probe S2 (`ops/microbench.mul_chain`), which replaces
`scripts/tpu_microbench.py:mul_kernel`; at one element and a long K it is
the latency probe of one dependent product.  `product` picks one of the
port's five Montgomery products (`csrc/field.cuh`), all giving the same
words: "unrolled" (fe_mul: this kernel's own, the NTT's elementwise
product), "rolled" (S1's), "cc" (the PTX carry-chain product of B1's
bucket walk, B2 and B4), "cc_rolled" (its rolled form, fe_mul_n: B3's) and
"wide" (fe_mul_wide: each 32x32->64 product a low/high pair in one carry
chain, even and odd words of a in two accumulators; B1's batched madd).
`Field.mul` runs FIELD_PRODUCT, the fastest at K = 1 (PERF.md §6).

`addsub_rows(field, a, b, op)`: a_i + b_j, a_i - b_j or b_j - a_i (op
"add", "sub", "rsub") with j = i mod nb: every `Field.add`, `sub`, `neg` and
`double` on a CUDA tensor.

`ring_op(field, op, a, b)` is `Field`'s ring op on CUDA tensors: one launch
of one of the two kernels for the broadcasts the call sites use (two
operands of one shape, or one of them a single (8,) element, on either
side), operands read at their row stride where they have one.  Any other
broadcast (6 of a trivial Cyclefold step's ~1,400 ring ops) expands the
smaller operand first.

Kernels: `csrc/field_ops.cu`, bandwidth kernels at K = 1 (2 elements per
thread, 16-byte loads and stores, 32-bit index arithmetic), one chain per
thread at K > 1 (design and bound noted there).  Each wrapper takes its
plain twin for CPU tensors only; for CUDA tensors it launches its kernel or
raises.  The twins run `Field.limbs`, the limb arithmetic on any device, so
a card check of a kernel against its twin never compares the kernel with
itself.  `mul_rows.launches` and `addsub_rows.launches` count the wrappers'
kernel launches, and `mul_rows.shapes` counts them by (n, nb) as well: nb = 1
with b = R^2 is the SPS's conversion of a replayed witness to Montgomery
form (`Field.to_mont_words`).  The ring ops' launches are kept apart:
`ring_op.launches` counts them by kernel, and `_build.device_launches` by
device under "ring_op".
"""

from __future__ import annotations

import math
from collections import Counter

import torch

from ..fields.jfield import WORDS, Field

PRODUCTS = ("unrolled", "rolled", "cc", "cc_rolled", "wide")  # csrc/field_ops.cu fe_mul_k's kinds
FIELD_PRODUCT = "unrolled"  # Field.mul's product on the card
ADDSUB_OPS = ("add", "sub", "rsub")  # csrc/field_ops.cu fe_addsub's ops
_SWAPPED = {"add": "add", "sub": "rsub", "mul": "mul"}  # op(a, b) == _SWAPPED[op](b, a)


def _check_words(t: torch.Tensor, what: str) -> None:
    if t.dim() != 2 or t.shape[1] != WORDS:
        raise ValueError(f"{what}: expected (n, {WORDS}) words, got {tuple(t.shape)}")


def _check_rows(what: str, a: torch.Tensor, b: torch.Tensor, rep: int) -> None:
    _check_words(a, f"{what} a")
    _check_words(b, f"{what} b")
    if b.shape[0] == 0 or rep < 1:
        raise ValueError(f"{what} needs at least one row of b and rep >= 1")
    if max(a.shape[0], b.shape[0], rep) >= 1 << 31:
        raise ValueError(f"{what} indexes rows in 32 bits: n, nb and rep below 2^31")


def _broadcast_rows(b: torch.Tensor, n: int, rep: int) -> torch.Tensor:
    """b's row (i // rep) mod nb for i < n: the kernels' broadcast, materialised."""
    if rep > 1:
        b = b.repeat_interleave(rep, 0)
    nb = b.shape[0]
    return b.repeat(-(-n // nb), 1)[:n] if nb != n else b


def _strided(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """An (n, 8) operand as the kernels read it: itself and its row stride
    where its words are dense and its rows whole rows apart (a stride of 0
    reads one row throughout), else a contiguous copy."""
    if t.stride(1) == 1 and t.stride(0) % WORDS == 0 and (t.shape[0] - 1) * t.stride(0) < 1 << 34:
        return t, t.stride(0) // WORDS
    return t.contiguous(), 1


def _launch(entry: str, field: Field, a: torch.Tensor, b: torch.Tensor, sizes: tuple, *args,
            counted_as: str | None = None) -> torch.Tensor:
    """`sirius_<entry>(consts, a, b, out, n, nb, *sizes, sa, sb, *args)` over
    a's rows against b's; the dense (n, 8) result."""
    from . import _build

    (a, sa), (b, sb) = _strided(a), _strided(b)
    _build.require_cuda(a, b, contiguous=False)
    _build.require_aligned(a, b)
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if a.shape[0]:
        _build.launch(entry, out, _build.field_consts(field), a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0],
                      b.shape[0], *sizes, sa, sb, *args, counted_as=counted_as)
    return out


def mul_rows_plain(field: Field, a: torch.Tensor, b: torch.Tensor, K: int = 1, rep: int = 1,
                   product: str = "unrolled") -> torch.Tensor:
    y = _broadcast_rows(b, a.shape[0], rep)
    for _ in range(K):
        a = field.limbs.mul(a, y)
    return a


def mul_rows(field: Field, a: torch.Tensor, b: torch.Tensor, K: int = 1, rep: int = 1,
             product: str = "unrolled") -> torch.Tensor:
    """a_i * b_((i // rep) mod nb)^K per row, by K chained Montgomery products
    (on `product`, one of PRODUCTS: the same words)."""
    _check_rows("mul_rows", a, b, rep)
    if product not in PRODUCTS:
        raise ValueError(f"product {product!r} is not one of {PRODUCTS}")
    if K < 0:
        raise ValueError("mul_rows needs K >= 0")
    if a.device.type == "cpu":
        return mul_rows_plain(field, a, b, K, rep, product)
    out = _launch("mul_rows", field, a, b, (rep,), K, PRODUCTS.index(product))
    if a.shape[0]:
        mul_rows.launches += 1
        shape = (a.shape[0], b.shape[0])
        mul_rows.shapes[shape] = mul_rows.shapes.get(shape, 0) + 1
    return out


mul_rows.launches = 0
mul_rows.shapes = {}


def addsub_rows_plain(field: Field, a: torch.Tensor, b: torch.Tensor, op: str = "add") -> torch.Tensor:
    f, y = field.limbs, _broadcast_rows(b, a.shape[0], 1)
    return f.add(a, y) if op == "add" else f.sub(a, y) if op == "sub" else f.sub(y, a)


def addsub_rows(field: Field, a: torch.Tensor, b: torch.Tensor, op: str = "add") -> torch.Tensor:
    """a_i + b_j, a_i - b_j or b_j - a_i (op "add", "sub" or "rsub") per row,
    j = i mod nb."""
    _check_rows("addsub_rows", a, b, 1)
    if op not in ADDSUB_OPS:
        raise ValueError(f"op {op!r} is not one of {ADDSUB_OPS}")
    if a.device.type == "cpu":
        return addsub_rows_plain(field, a, b, op)
    out = _launch("addsub_rows", field, a, b, (), ADDSUB_OPS.index(op))
    if a.shape[0]:
        addsub_rows.launches += 1
    return out


addsub_rows.launches = 0


def ring_op(field: Field, op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`field`'s op ("add", "sub" or "mul") of broadcasting (..., 8) CUDA
    tensors: one kernel launch (none for an empty result)."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    if a.shape[:-1] != shape and b.shape[:-1] == shape:  # the full operand first
        a, b, op = b, a, _SWAPPED[op]
    n = math.prod(shape)
    if n == 0:
        return torch.empty(shape + (WORDS,), dtype=a.dtype, device=a.device)
    if b.shape[:-1] != shape and math.prod(b.shape[:-1]) != 1:  # neither n rows nor one: expanded
        b = b.expand(shape + (WORDS,))
    a2 = a.expand(shape + (WORDS,)).reshape(n, WORDS)
    b2 = a2 if b is a else b.reshape(-1, WORDS)  # double and square: one copy where a's rows need one
    _check_rows("ring_op", a2, b2, 1)
    if not a2.is_cuda:  # the kernels' plain twins: the broadcast held to the limb arithmetic on the CPU
        out = mul_rows_plain(field, a2, b2) if op == "mul" else addsub_rows_plain(field, a2, b2, op)
    elif op == "mul":
        out = _launch("mul_rows", field, a2, b2, (1,), 1, PRODUCTS.index(FIELD_PRODUCT), counted_as="ring_op")
        ring_op.launches["mul_rows"] += 1
    else:
        out = _launch("addsub_rows", field, a2, b2, (), ADDSUB_OPS.index(op), counted_as="ring_op")
        ring_op.launches["addsub_rows"] += 1
    return out.reshape(shape + (WORDS,))


ring_op.launches = Counter()


def mul_rows_kernel_attrs(product: str | None = None) -> dict[str, int]:
    """Registers and local (spill) bytes per thread, static shared bytes per
    block, as the loaded library was built, of the instance the NTT path
    launches most (K = 1, rep = 1, the modulo, the unrolled product), or
    with `product` S2's instance on it (K > 1, one element a thread)."""
    import ctypes

    from . import _build

    out = (ctypes.c_longlong * 3)()
    kind = -1 if product is None else PRODUCTS.index(product)
    _build.check(_build.library().sirius_mul_rows_attrs(kind, out), "mul_rows_attrs")
    return {"numRegs": int(out[0]), "localSizeBytes": int(out[1]), "sharedSizeBytes": int(out[2])}
