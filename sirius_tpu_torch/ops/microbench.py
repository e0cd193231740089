"""S2, S3, S4: the field-rate and build probes, CUDA wrappers + plain torch twins.

  mul_chain      (S2)  K = 8 chained Montgomery products a <- a * b per
                       element (`scripts/tpu_microbench.py:mul_kernel`):
                       the port's field product `field_kernels.mul_rows` at
                       K = 8, so its launches count on `mul_rows.launches`
  raw_u32        (S3)  reps chained 32-bit multiplies or adds b = op(b, a)
                       mod 2^32 (`scripts/tpu_microbench.py:raw_kernel`), on
                       the TPU probe's 4-byte words: an int32 tensor holds
                       the u32 bits, in and out
  probe_add_one  (S4)  x + 1 mod 2^32 on an (8, 128) tile
                       (`scripts/lower_dump.py:tiny`)

Kernels: `csrc/field_ops.cu` (S2) and `csrc/microbench.cu` (S3, S4); what
bounds each is noted there.  Each wrapper takes its plain twin for CPU
tensors only; for CUDA tensors it launches its kernel or raises.
`<wrapper>.launches` counts kernel launches.  Torch has no uint32
arithmetic on the CPU: S3's plain twin widens its int32 words to int64 and
narrows the result back, and S4 keeps its 32-bit values in int64.
"""

from __future__ import annotations

import torch

from ..fields.jfield import Field
from .field_kernels import mul_rows, mul_rows_plain

M32 = 0xFFFFFFFF
RAW_OPS = ("mul", "add")
RAW_WORDS = torch.int32  # raw_u32's words: the u32 bits


# -- plain twins -------------------------------------------------------------------


def mul_chain_plain(field: Field, a: torch.Tensor, b: torch.Tensor, K: int = 8,
                    product: str = "unrolled") -> torch.Tensor:
    return mul_rows_plain(field, a, b, K, product=product)


def _mul32(b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """b * a mod 2^32 for values below 2^32, exact in int64: a in 16-bit
    halves keeps every partial product below 2^48."""
    return (b * (a & 0xFFFF) + (((b * (a >> 16)) & 0xFFFF) << 16)) & M32


def u32_of(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> their u32 values in int64."""
    return words.to(torch.int64) & M32


def words_of(u32: torch.Tensor) -> torch.Tensor:
    """int64 values below 2^32 -> int32 words with the same bits."""
    return torch.where(u32 > 0x7FFFFFFF, u32 - (1 << 32), u32).to(RAW_WORDS)


def raw_u32_plain(a: torch.Tensor, op: str = "mul", reps: int = 64) -> torch.Tensor:
    a = u32_of(a)
    b = a
    for _ in range(reps):
        b = _mul32(b, a) if op == "mul" else (b + a) & M32
    return words_of(b)


def probe_add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return (x + 1) & M32


# -- kernel wrappers ---------------------------------------------------------------


def mul_chain(field: Field, a: torch.Tensor, b: torch.Tensor, K: int = 8, product: str = "unrolled") -> torch.Tensor:
    """(n, 8) a and (nb, 8) b in Montgomery form -> a_i * b_(i mod nb)^K,
    by K chained Montgomery products on `product` (one of
    `field_kernels.PRODUCTS`)."""
    return mul_rows(field, a, b, K, product=product)


def raw_u32(a: torch.Tensor, op: str = "mul", reps: int = 64) -> torch.Tensor:
    """(n,) int32 words (u32 bits) -> the int32 words of b after reps steps
    b = op(b, a) mod 2^32, b = a."""
    if op not in RAW_OPS:
        raise ValueError(f"raw_u32 op {op!r} not in {RAW_OPS}")
    if a.dim() != 1 or a.dtype != RAW_WORDS:
        raise ValueError(f"raw_u32: expected a 1-D {RAW_WORDS} tensor, got {a.dtype} {tuple(a.shape)}")
    if reps < 0:
        raise ValueError(f"raw_u32: reps {reps} < 0")
    if a.device.type == "cpu":
        return raw_u32_plain(a, op, reps)
    from . import _build

    a = a.contiguous()
    _build.require_cuda(a, dtype=RAW_WORDS)
    if a.data_ptr() % 16:  # the kernel moves 4 words in one 16-byte load
        a = a.clone()
    out = torch.empty_like(a)
    if a.shape[0]:
        _build.launch("raw_u32", a, a.data_ptr(), out.data_ptr(), a.shape[0], RAW_OPS.index(op), reps)
        raw_u32.launches += 1
    return out


def probe_add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1 mod 2^32 elementwise (int64 values below 2^32)."""
    if x.device.type == "cpu":
        return probe_add_one_plain(x)
    from . import _build

    x = x.contiguous()
    _build.require_cuda(x)
    out = torch.empty_like(x)
    if x.numel():
        _build.launch("add_one", x, x.data_ptr(), out.data_ptr(), x.numel())
        probe_add_one.launches += 1
    return out


raw_u32.launches = 0
probe_add_one.launches = 0
