"""Traced stand-ins for the dry syntheses that collect the IVC structures.

The port's own copy of `sirius_tpu/frontend/taped.py`, without the replay:
the public parameters synthesize each circuit once with `Tr` handles
(`frontend/tape.py`) standing in for its dynamic inputs, and collect the
structure from that synthesis.
"""

from __future__ import annotations

from .tape import TapeBuilder


class _TrPoint:
    """Affine-point stand-in whose coordinates are traced values (identity
    pre-encoded as (0, 0), matching `EccChip.assign_point(None)`)."""

    __slots__ = ("x", "y")
    is_identity = False

    def __init__(self, x, y):
        self.x = x
        self.y = y


def point_leaves(pt) -> tuple:
    """Canonical (x, y) leaves of a gold affine point (identity -> (0, 0))."""
    return (0, 0) if pt.is_identity else (pt.x, pt.y)


def sc_trace_bind(tape: TapeBuilder, sc):
    """Install Tr tape inputs over a stateful step circuit's dynamic witness
    (see ivc/step_circuit.py); returns a restore callable.  No-op for pure
    circuits.  Must run AFTER the main input wrapping so the flatten order
    (inputs, then step-circuit witness) matches."""
    fn = getattr(sc, "dynamic_witness", None)
    if fn is None:
        return lambda: None
    orig = list(fn())
    sc.bind_witness([tape.input() for _ in orig])
    return lambda: sc.bind_witness(orig)
