"""The elementwise field product on the card: CUDA wrapper + plain torch twin.

`mul_rows(field, a, b, K=1, rep=1)`: (n, 8) a and (nb, 8) b in Montgomery
form -> a_i * b_((i // rep) mod nb)^K, by K chained Montgomery products, b
broadcast over a's rows with each row repeated rep times.  K = 1 is the
NTT's elementwise product (coset powers; the flat route's 1/n; the mid
twiddle where a four-step's first pass is itself nested, over R columns at
once with rep = R; the doubling build of the mid twiddle); K = 8 is the field-rate
probe S2 (`ops/microbench.mul_chain`), which replaces
`scripts/tpu_microbench.py:mul_kernel`; at one element and a long K it is
the latency probe of one dependent product.  `product` picks one of the
port's five Montgomery products (`csrc/field.cuh`), all giving the same
words: "unrolled" (fe_mul: this kernel's own, the NTT's elementwise
product), "rolled" (S1's), "cc" (the PTX carry-chain product of B1's
bucket walk, B2 and B4), "cc_rolled" (its rolled form, fe_mul_n: B3's) and
"wide" (fe_mul_wide: each 32x32->64 product a low/high pair in one carry
chain, even and odd words of a in two accumulators; B1's batched madd).

Kernel: `csrc/field_ops.cu`, a bandwidth kernel at K = 1 (2 elements per
thread, 16-byte loads and stores, 32-bit index arithmetic), one chain per
thread at K > 1 (design and bound noted there).  The wrapper takes its
plain twin for CPU tensors only; for CUDA tensors it launches its kernel
or raises.  `mul_rows.launches` counts kernel launches, and
`mul_rows.shapes` counts them by (n, nb) as well: nb = 1 with b = R^2 is
the SPS's conversion of a replayed witness to Montgomery form
(`Field.to_mont_words`).
"""

from __future__ import annotations

import torch

from ..fields.jfield import WORDS, Field

PRODUCTS = ("unrolled", "rolled", "cc", "cc_rolled", "wide")  # csrc/field_ops.cu fe_mul_k's kinds


def _check_words(t: torch.Tensor, what: str) -> None:
    if t.dim() != 2 or t.shape[1] != WORDS:
        raise ValueError(f"{what}: expected (n, {WORDS}) words, got {tuple(t.shape)}")


def mul_rows_plain(field: Field, a: torch.Tensor, b: torch.Tensor, K: int = 1, rep: int = 1,
                   product: str = "unrolled") -> torch.Tensor:
    if rep > 1:
        b = b.repeat_interleave(rep, 0)
    n, nb = a.shape[0], b.shape[0]
    y = b.repeat(-(-n // nb), 1)[:n] if nb != n else b
    for _ in range(K):
        a = field.mul(a, y)
    return a


def mul_rows(field: Field, a: torch.Tensor, b: torch.Tensor, K: int = 1, rep: int = 1,
             product: str = "unrolled") -> torch.Tensor:
    """a_i * b_((i // rep) mod nb)^K per row, by K chained Montgomery products
    (on `product`, one of PRODUCTS: the same words)."""
    _check_words(a, "mul_rows a")
    _check_words(b, "mul_rows b")
    if product not in PRODUCTS:
        raise ValueError(f"product {product!r} is not one of {PRODUCTS}")
    if b.shape[0] == 0 or K < 0 or rep < 1:
        raise ValueError("mul_rows needs at least one row of b, K >= 0 and rep >= 1")
    if max(a.shape[0], b.shape[0], rep) >= 1 << 31:
        raise ValueError("mul_rows indexes rows in 32 bits: n, nb and rep below 2^31")
    if a.device.type == "cpu":
        return mul_rows_plain(field, a, b, K, rep, product)
    from . import _build

    a, b = a.contiguous(), b.contiguous()
    _build.require_cuda(a, b)
    _build.require_aligned(a, b)
    out = torch.empty_like(a)
    if a.shape[0]:
        _build.launch("mul_rows", a, _build.field_consts(field), a.data_ptr(), b.data_ptr(), out.data_ptr(),
                      a.shape[0], b.shape[0], rep, K, PRODUCTS.index(product))
        mul_rows.launches += 1
        shape = (a.shape[0], b.shape[0])
        mul_rows.shapes[shape] = mul_rows.shapes.get(shape, 0) + 1
    return out


mul_rows.launches = 0
mul_rows.shapes = {}


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
