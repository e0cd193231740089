"""Value helpers of the witness tape, on plain ints.

The port's copy of the three helpers of `sirius_tpu/frontend/tape.py` that
the gadgets call (`bit`, `inv0`, `is_zero`).  The port synthesizes every
witness directly on Python ints, so the traced (`Tr`) branches and the
native replay are not carried over.
"""

from __future__ import annotations


def inv0(x, m: int):
    """x^-1 mod m, or 0 when x == 0 (mod m)."""
    x = x % m
    return pow(x, -1, m) if x else 0


def is_zero(x):
    """1 if x == 0 else 0 (x must be reduced already)."""
    return 1 if x == 0 else 0


def bit(x, i: int):
    """(x >> i) & 1 as one op."""
    return (x >> i) & 1
