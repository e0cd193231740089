"""Canonical accumulator digests — the self-golden-vector regime.

The port's own copy of `sirius_tpu/util/golden.py`, with what the
port's paths use (the port imports nothing of the JAX package).

BASELINE.json's acceptance criterion ("bit-exact folded accumulators vs the
Rust reference") is unfalsifiable in this environment: there is no Rust
toolchain, the reference's accumulator values are computed (not inline) in
its tests, and PARITY.md documents deliberate encoding deviations
(hash_to_curve pipeline, pp-digest serialization, limb geometry).  The
re-scoped criterion (PARITY.md "Bit-exactness scope") is:

  1. primitive-level bit-exactness vs the reference's inline golden vectors
     (Poseidon, FFT, Lagrange — tested in the default suite), and
  2. CROSS-VERSION bit-exactness of folded accumulators for frozen example
     configurations: the digests below must never drift between commits,
     so any unintended change to the transcript, fold arithmetic, layout,
     or hashing shows up as a golden-digest test failure.

The digest is a SHA-256 over a canonical little-endian encoding of every
instance-level accumulator field (witnesses enter via their commitments).
"""

from __future__ import annotations

import hashlib


def _enc_int(h, v: int):
    h.update(int(v).to_bytes(64, "little", signed=False))


def _enc_point(h, pt):
    if pt.is_identity:
        _enc_int(h, 0)
        _enc_int(h, 0)
    else:
        _enc_int(h, pt.x)
        _enc_int(h, pt.y)


def sangria_acc_digest(acc_U) -> str:
    """RelaxedPlonkInstance -> hex digest."""
    h = hashlib.sha256()
    for c in acc_U.W_commitments:
        _enc_point(h, c)
    for v in acc_U.consistency_markers:
        _enc_int(h, v)
    for v in acc_U.challenges:
        _enc_int(h, v)
    _enc_point(h, acc_U.E_commitment)
    _enc_int(h, acc_U.u)
    if acc_U.sc_instances_hash_acc is not None:
        _enc_int(h, acc_U.sc_instances_hash_acc)
    return h.hexdigest()


def pg_acc_digest(acc_ins) -> str:
    """protogalaxy.AccumulatorInstance -> hex digest."""
    h = hashlib.sha256()
    for c in acc_ins.ins.W_commitments:
        _enc_point(h, c)
    for inst in acc_ins.ins.instances:
        for v in inst:
            _enc_int(h, v)
    for v in acc_ins.ins.challenges:
        _enc_int(h, v)
    for b in acc_ins.betas:
        _enc_int(h, b)
    _enc_int(h, acc_ins.e)
    return h.hexdigest()
