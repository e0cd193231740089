"""TapedSynthesis: per-shape witness programs for the IVC hot loop.

The port's own copy of `sirius_tpu/frontend/taped.py`.  Couples
`frontend/tape.py` (the op recorder and native interpreter) to the circuit
frontend: a circuit is synthesized ONCE with `Tr` handles standing in for
its dynamic inputs (during public-parameter construction, where a dry
synthesis happens anyway for structure collection), and every fold step
replays the recorded tape natively instead of re-running the Python gadget
stack (reference counterpart: the native closures in
`src/table/witness_collector.rs`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .circuit import Assignment
from .tape import TapeBuilder, Tr


def _words_to_ints(col: np.ndarray) -> list[int]:
    buf = np.ascontiguousarray(col, dtype="<u4").tobytes()
    return [int.from_bytes(buf[i * 32 : (i + 1) * 32], "little") for i in range(col.shape[0])]


class ReplayedWitness:
    """Advice columns as standard-form (n, 8) uint32 word arrays (packed
    32 bytes a value: half the upload of the int64 word tensors).

    Iterating yields per-column Python-int lists (the plain form, for tests
    and host readers); `plonk/sps.concat_with_padding` uploads the words
    and converts them to Montgomery form on the device.
    """

    __slots__ = ("cols",)

    def __init__(self, cols: list[np.ndarray]):
        self.cols = cols

    def __len__(self):
        return len(self.cols)

    def __iter__(self):
        for col in self.cols:
            yield _words_to_ints(col)

    def __getitem__(self, i):
        return _words_to_ints(self.cols[i])


class TapedSynthesis:
    """A traced circuit shape: replay witness values for new inputs.

    Built from the Assignment of a trace-mode synthesis run.  Advice cells
    that were assigned host ints (structural constants, lookup tables) are
    baked into a static per-column template; traced cells are scattered
    from the replay output.
    """

    def __init__(self, tape: TapeBuilder, asn: Assignment, named: dict[str, object]):
        self.tape = tape
        self.n = asn.n
        n = asn.n

        dyn_slots: list[int] = []
        self._cols: list[tuple[np.ndarray, np.ndarray, int, int]] = []
        # per column: (template (n, 8) u32 words, dyn_rows, dyn_start, dyn_len)
        for col_vals in asn.advice:
            tmpl = np.zeros((n, 8), dtype=np.uint32)
            static_rows: list[int] = []
            static_vals: list[int] = []
            rows: list[int] = []
            start = len(dyn_slots)
            for r, v in enumerate(col_vals):
                if isinstance(v, Tr):
                    rows.append(r)
                    dyn_slots.append(v.s)
                elif v:
                    static_rows.append(r)
                    static_vals.append(v)
            if static_vals:
                buf = b"".join(int(v).to_bytes(32, "little") for v in static_vals)
                tmpl[np.asarray(static_rows)] = np.frombuffer(buf, dtype="<u4").reshape(-1, 8)
            self._cols.append((tmpl, np.asarray(rows, dtype=np.int64), start, len(rows)))

        self._named_slots: dict[str, int] = {}
        self._named_static: dict[str, int] = {}
        for name, v in named.items():
            if isinstance(v, Tr):
                self._named_slots[name] = len(dyn_slots)
                dyn_slots.append(v.s)
            else:
                self._named_static[name] = int(v)
        self._out_slots = np.asarray(dyn_slots, dtype=np.uint32)

    def sizes(self) -> dict[str, int]:
        """The tape's ops, inputs, constants and output slots."""
        t = self.tape
        return {"ops": len(t.code), "inputs": t.n_inputs, "consts": len(t.consts), "out_slots": len(self._out_slots)}

    def replay(self, inputs: Sequence[int]) -> tuple[ReplayedWitness, dict[str, int]]:
        raw = self.tape.replay([int(v) for v in inputs], self._out_slots)
        words = raw.view("<u4").reshape(-1, 8)
        cols = []
        for tmpl, rows, start, ln in self._cols:
            col = tmpl.copy()
            if ln:
                col[rows] = words[start : start + ln]
            cols.append(col)
        named = dict(self._named_static)
        for name, ix in self._named_slots.items():
            named[name] = int.from_bytes(bytes(raw[ix]), "little")
        return ReplayedWitness(cols), named


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


def sc_dynamic_values(sc) -> list[int]:
    """Current dynamic-witness leaves of a step circuit ([] if pure)."""
    fn = getattr(sc, "dynamic_witness", None)
    return [] if fn is None else [int(v) for v in fn()]


def sc_is_stateful(sc) -> bool:
    return getattr(sc, "dynamic_witness", None) is not None
