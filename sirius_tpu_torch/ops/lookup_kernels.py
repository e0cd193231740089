"""The lookup's multiplicity count on the card: the CUDA wrapper.

`m_count(l, t)`: (n, 8) canonical words l and t (Montgomery or standard,
one form for both) -> (n,) int32, the number of rows of l equal to each row
of t, given to the first row of t holding that value only (every later
duplicate 0; a row of l in no row of t counts nowhere).  The log-derivative
prover's m vector (`plonk/lookup.py`); its plain version, `m_count_plain`,
stands beside it.

Kernel: `csrc/lookup.cu`, a hash table in global memory built by one launch
over t (`lookup_insert`) and probed by a second over l (`lookup_probe`);
its design and bound are noted there.  It has no Pallas counterpart (the
JAX package sorts and binary-searches, `sirius_tpu/plonk/lookup.py:54-88`).
The wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches its kernels or raises.  `m_count.launches` counts calls that
launched the pair.
"""

from __future__ import annotations

import torch

from ..fields.jfield import WORDS

EMPTY = -1  # csrc/lookup.cu LOOKUP_EMPTY
MAX_ROWS = 1 << 30


def table_capacity(n: int) -> int:
    """Slots of the hash table for n rows of t: a power of two, at least 2n."""
    return 1 << max(1, (2 * n - 1).bit_length())


def m_count_plain(l: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The plain version of `m_count`: (n, 8) words l and t -> (n,) int32
    counts of l's rows at the first occurrence of each row of t.  Ids of
    the distinct rows of t and l together, the first row of t of each id
    (scatter_reduce amin), the rows of l counted by id."""
    n = t.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=t.device)
    _, ids = torch.unique(torch.cat([t, l]), dim=0, return_inverse=True)
    ids_t, ids_l = ids[:n], ids[n:]
    rows = torch.arange(n, device=t.device)
    first = torch.full((int(ids.max()) + 1,), n, dtype=torch.int64, device=t.device)
    first = first.scatter_reduce(0, ids_t, rows, "amin")
    counts = torch.bincount(ids_l, minlength=first.shape[0])
    return torch.where(first[ids_t] == rows, counts[ids_t], 0).to(torch.int32)


def m_count(l: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    for x, what in ((l, "l"), (t, "t")):
        if x.dim() != 2 or x.shape[1] != WORDS:
            raise ValueError(f"m_count {what}: expected (n, {WORDS}) words, got {tuple(x.shape)}")
        if x.shape[0] >= MAX_ROWS:
            raise ValueError(f"m_count {what}: {x.shape[0]} rows, the kernel takes fewer than 2^30")
    if t.device.type == "cpu":
        return m_count_plain(l, t)
    from . import _build

    l, t = l.contiguous(), t.contiguous()
    _build.require_cuda(l, t)
    n, nl = t.shape[0], l.shape[0]
    counts = torch.zeros(n, dtype=torch.int32, device=t.device)
    if n and nl:
        cap = table_capacity(n)
        slots = torch.full((cap,), EMPTY, dtype=torch.int32, device=t.device)
        _build.launch("lookup_insert", t, t.data_ptr(), slots.data_ptr(), n, cap)
        _build.launch("lookup_probe", t, l.data_ptr(), t.data_ptr(), slots.data_ptr(), counts.data_ptr(), nl, n, cap)
        m_count.launches += 1
    return counts


m_count.launches = 0
