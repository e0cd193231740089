"""Public-parameter digests.

The port's own copy of `sirius_tpu/util/digest.py`, with what the
port's paths use (the port imports nothing of the JAX package).

Replaces reference `src/digest.rs` (SURVEY.md §2.1): serialize -> SHA3-256 ->
interpret NUM_HASH_BITS (250) little-endian bits as a scalar -> multiply the
curve generator.  Serialization here is a canonical little-endian integer
encoding of the structure's defining data (not Rust bincode; see PARITY.md).
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import Iterable

import numpy as np

from ..fields import gold
from ..fields.constants import CurveSpec
from ..util.ro import NUM_HASH_BITS


def digest_ints_to_bits(data: Iterable[bytes]) -> int:
    """SHA3-256 over the byte stream, truncated to NUM_HASH_BITS LE bits
    (reference `digest.rs:17-34` + `bytes_to_bits_le` semantics)."""
    h = hashlib.sha3_256()
    for chunk in data:
        h.update(chunk)
    value = int.from_bytes(h.digest(), "little")
    return value & ((1 << NUM_HASH_BITS) - 1)


def into_curve_from_bits(curve: CurveSpec, bits_value: int) -> gold.AffinePoint:
    """generator * scalar (reference `digest.rs:66-88`)."""
    return gold.generator(curve).mul(bits_value % curve.scalar.modulus)



@lru_cache(maxsize=1 << 16)
def _int_bytes(v: int, width: int) -> bytes:
    # fixed columns repeat a handful of distinct constants across 2^k rows;
    # memoizing the little-endian encoding removes millions of to_bytes
    # calls per structure digest (byte stream unchanged)
    return v.to_bytes(width, "little")


def serialize_ints(*values: int, width: int = 32) -> list[bytes]:
    return [_int_bytes(v, width) for v in values]


def structure_digest_stream(S) -> list[bytes]:
    """Canonical byte stream for a PlonkStructure: shape metadata, selector
    bitmaps, fixed columns, gate structure fingerprints."""
    out = [b"sirius_tpu.plonk_structure.v1"]
    out += serialize_ints(S.k, len(S.num_io), *S.num_io, S.num_advice_columns, S.num_challenges, width=8)
    out += serialize_ints(*S.round_sizes, width=8)
    out.append(np.packbits(S.selectors.astype(np.uint8)).tobytes())
    for col in S.fixed_columns:
        out.append(b"".join(_int_bytes(v, 32) for v in col))
    for g in S.gates:
        out.append(g.visualize().encode())
    return out
