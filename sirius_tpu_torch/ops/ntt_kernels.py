"""B4: the column NTT, CUDA wrapper + plain torch twin.

Replaces `sirius_tpu/ops/pallas_ntt.py:col_ntt_pallas` (body
`_ladder_body`).  Kernel: `csrc/ntt.cu`, C columns per thread block in
shared memory with one copy of the twiddles, 4 elements per thread in
registers (8 for columns above 1024) and 2 (3) radix-2 stages between
exchanges (design and bound noted there).

`col_ntt(field, a, rev, table)`: for a (size, R, 8) block of Montgomery
words, permute the size axis by `rev` (the bit reversal) and run every
radix-2 stage along it; `table` is (size/2, 8) with table[k] = w^k for an
order-`size` root w.
`col_ntt(field, a, rev, table, mid, rep)`: the epilogue variant, the first
pass of a four-step with its mid twiddle and transpose folded in: output
(o1, column) times mid[o1 * n2 + column // rep] (n2 = R // rep), stored
transposed as an (n2, size * rep, 8) block, row (i2, o1 * rep + column %
rep): `mul_rows(..., rep=rep)` then a transpose, in the pass's own store.
The wrapper takes the plain twin for CPU tensors only; for CUDA tensors it
launches the kernel or raises.  `col_ntt.launches` counts kernel launches,
`col_ntt.mid_launches` those of the epilogue variant among them.
"""

from __future__ import annotations

import torch

from ..fields.jfield import WORDS, Field
from .field_kernels import mul_rows_plain

MAX_SIZE = 4096  # a column + the twiddles in shared memory: 6144 * 32 B = 192 KB of the 227 KB
KERNELS = ("col_ntt", "col_ntt_mid")  # csrc/ntt.cu col_ntt_kernel<2, false>, <2, true>: a column of 1024


def _check(a: torch.Tensor, rev: torch.Tensor, table: torch.Tensor, mid, rep: int) -> int:
    if a.dim() != 3 or a.shape[2] != WORDS:
        raise ValueError(f"col_ntt: expected a (size, R, {WORDS}) block, got {tuple(a.shape)}")
    size, R = a.shape[:2]
    if size < 1 or size & (size - 1):
        raise ValueError(f"col_ntt: size {size} is not a power of two")
    if rev.shape != (size,):
        raise ValueError(f"col_ntt: rev has shape {tuple(rev.shape)}, expected ({size},)")
    if table.shape != (max(size // 2, 1), WORDS):
        raise ValueError(f"col_ntt: table has shape {tuple(table.shape)}, expected ({max(size // 2, 1)}, {WORDS})")
    if mid is not None:
        if rep < 1 or R % rep:
            raise ValueError(f"col_ntt: rep {rep} does not divide the {R} columns")
        if mid.shape != (size * R // rep, WORDS):
            raise ValueError(f"col_ntt: mid has shape {tuple(mid.shape)}, expected ({size * R // rep}, {WORDS})")
    return size


def col_ntt_plain(field: Field, a: torch.Tensor, rev: torch.Tensor, table: torch.Tensor,
                  mid: torch.Tensor | None = None, rep: int = 1) -> torch.Tensor:
    field = field.limbs
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
    if mid is None:
        return a
    b = mul_rows_plain(field, a.reshape(-1, WORDS), mid, rep=rep)
    return b.reshape(size, R // rep, rep, WORDS).transpose(0, 1).reshape(R // rep, size * rep, WORDS)


def col_ntt(field: Field, a: torch.Tensor, rev: torch.Tensor, table: torch.Tensor,
            mid: torch.Tensor | None = None, rep: int = 1) -> torch.Tensor:
    """NTT along axis 0 of a (size, R, 8) block, bit reversal included; with
    `mid`, times the mid twiddle and transposed to (R // rep, size * rep, 8)."""
    size = _check(a, rev, table, mid, rep)
    if a.device.type == "cpu":
        return col_ntt_plain(field, a, rev, table, mid, rep)
    if size > MAX_SIZE:
        raise ValueError(f"col_ntt: size {size} > {MAX_SIZE} does not fit one block's shared memory")
    from . import _build

    R = a.shape[1]
    ops = [a.contiguous(), rev.contiguous(), table.contiguous()] + ([] if mid is None else [mid.contiguous()])
    _build.require_cuda(*ops)
    _build.require_aligned(ops[0], ops[2], *ops[3:])
    out = torch.empty_like(ops[0]) if mid is None else ops[0].new_empty((R // rep, size * rep, WORDS))
    if R:
        _build.launch("col_ntt", ops[0], _build.field_consts(field), ops[0].data_ptr(), ops[1].data_ptr(),
                      ops[2].data_ptr(), None if mid is None else ops[3].data_ptr(), out.data_ptr(), size, R, rep)
        col_ntt.launches += 1
        col_ntt.mid_launches += mid is not None
    return out


col_ntt.launches = 0
col_ntt.mid_launches = 0


def col_ntt_kernel_attrs(name: str) -> dict[str, int]:
    """Registers and local (spill) bytes per thread, static shared bytes per
    block, of `name` (one of KERNELS) as the loaded library was built."""
    import ctypes

    from . import _build

    out = (ctypes.c_longlong * 3)()
    _build.check(_build.library().sirius_col_ntt_attrs(KERNELS.index(name), out), "col_ntt_attrs")
    return {"numRegs": int(out[0]), "localSizeBytes": int(out[1]), "sharedSizeBytes": int(out[2])}
