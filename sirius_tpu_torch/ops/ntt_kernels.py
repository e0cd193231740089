"""B4: the column NTT, CUDA wrapper + plain torch twin.

Replaces `sirius_tpu/ops/pallas_ntt.py:col_ntt_pallas` (body
`_ladder_body`).  Kernel: `csrc/ntt.cu`, one thread block per column with
the column and its twiddles resident in shared memory (design and bound
noted there).

`col_ntt(field, a, rev, table)`: for a (size, R, 8) block of Montgomery
words, permute the size axis by `rev` (the bit reversal) and run every
radix-2 stage along it; `table` is (size/2, 8) with table[k] = w^k for an
order-`size` root w.  The wrapper takes the plain twin for CPU tensors
only; for CUDA tensors it launches the kernel or raises.
`col_ntt.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..fields.jfield import WORDS, Field

MAX_SIZE = 4096  # column + twiddles in shared memory: 6144 * 32 B = 192 KB of the 227 KB


def _check(a: torch.Tensor, rev: torch.Tensor, table: torch.Tensor) -> int:
    if a.dim() != 3 or a.shape[2] != WORDS:
        raise ValueError(f"col_ntt: expected a (size, R, {WORDS}) block, got {tuple(a.shape)}")
    size = a.shape[0]
    if size < 1 or size & (size - 1):
        raise ValueError(f"col_ntt: size {size} is not a power of two")
    if rev.shape != (size,):
        raise ValueError(f"col_ntt: rev has shape {tuple(rev.shape)}, expected ({size},)")
    if table.shape != (max(size // 2, 1), WORDS):
        raise ValueError(f"col_ntt: table has shape {tuple(table.shape)}, expected ({max(size // 2, 1)}, {WORDS})")
    return size


def col_ntt_plain(field: Field, a: torch.Tensor, rev: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    size, R = a.shape[:2]
    a = a[rev]
    m = 1
    while m < size:
        nb = size // (2 * m)
        view = a.reshape(nb, 2, m, R, WORDS)
        lo, hi = view[:, 0], view[:, 1]
        if m == 1 and size > 2:
            t = hi  # w^0 == 1
        else:
            w = table[::nb][:m]  # (m, 8)
            t = field.mul(hi, w[None, :, None, :])
        a = torch.stack([field.add(lo, t), field.sub(lo, t)], 1).reshape(size, R, WORDS)
        m *= 2
    return a


def col_ntt(field: Field, a: torch.Tensor, rev: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """NTT along axis 0 of a (size, R, 8) block, bit reversal included."""
    size = _check(a, rev, table)
    if a.device.type == "cpu":
        return col_ntt_plain(field, a, rev, table)
    if size > MAX_SIZE:
        raise ValueError(f"col_ntt: size {size} > {MAX_SIZE} does not fit one block's shared memory")
    from . import _build

    a, rev, table = a.contiguous(), rev.contiguous(), table.contiguous()
    _build.require_cuda(a, rev, table)
    out = torch.empty_like(a)
    R = a.shape[1]
    if R:
        err = _build.library().sirius_col_ntt(_build.field_consts(field), a.data_ptr(), rev.data_ptr(),
                                              table.data_ptr(), out.data_ptr(), size, R, _build.stream_of(a))
        _build.check(err, "col_ntt")
        col_ntt.launches += 1
    return out


col_ntt.launches = 0
