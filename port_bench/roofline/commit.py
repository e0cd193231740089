"""The least time a Pedersen commitment (an MSM) can take on the card.

Whatever the algorithm, a commit of n scalars against n key points reads
every scalar (32 bytes, a 256-bit field element) and every affine key point
(64 bytes: two 256-bit coordinates) once and writes each result point (64
bytes) once.  At the card's HBM rate that is a floor no implementation goes
below.  No operation floor is added: the group operations an MSM needs
depend on its algorithm (window width, precomputation), so no count of
them binds every implementation.
"""

from __future__ import annotations

import json
from pathlib import Path

SCALAR_BYTES = 32
POINT_BYTES = 64
PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def commit_bytes(scalars: int, points: int, results: int) -> int:
    """Bytes a commit must move: its scalars and key points read once, its
    results written once."""
    return SCALAR_BYTES * scalars + POINT_BYTES * points + POINT_BYTES * results


def least_seconds(scalars: int, points: int, results: int, hbm_bytes_per_s: float = PEAKS["hbm_bytes_per_s"]
                  ) -> float:
    return commit_bytes(scalars, points, results) / hbm_bytes_per_s
