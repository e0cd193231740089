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

import numpy as np


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


def plonk_trace_digest(W_words, instance) -> str:
    """A plain trace -> hex digest: every W round's Montgomery words ((n, 8)
    32-bit words as numpy arrays, 32 bytes an element, little-endian), then
    the W commitments, the instance columns and the challenges."""
    h = hashlib.sha256()
    for w in W_words:
        h.update(np.ascontiguousarray(np.asarray(w).astype("<u4")).tobytes())
    for c in instance.W_commitments:
        _enc_point(h, c)
    for inst in instance.instances:
        for v in inst:
            _enc_int(h, v)
    for v in instance.challenges:
        _enc_int(h, v)
    return h.hexdigest()


# Sangria IVC on `TrivialStepCircuit(1)` both sides, k1 = k2 = 16, mock keys
# (`util/testing.MockCommitmentKey`), z0 = [0x11] / [0x22]: the JAX package's
# `sirius_tpu/ivc/sangria_ivc.py` run on the CPU, frozen.  The pp digest
# points (affine x, y on bn256 and on grumpkin) and `sangria_acc_digest` of
# the (primary, secondary) relaxed instances after `IVC(...)` and after one
# `fold_step()`.
SANGRIA_IVC_K16_PP_DIGEST_1 = (
    9819562387128035433135519526325461625769612566071672557755081981000565151781,
    4909835317067816932168364630470844746129991275860918372998752337402559205112,
)
SANGRIA_IVC_K16_PP_DIGEST_2 = (
    3654089299844383669813660638963876496266822595449127202762804346367441377620,
    5598962449376080124067008313437006056691379627229200826787441529004200697003,
)
SANGRIA_IVC_K16_NEW = (
    "7691f83193259a78ff91363075d579e1541eaf9edadadb0ee2b167393ddb51cf",
    "bcbb0188e4c2e1846f96857824733f8d93ff6e2160b42abdf6306f67a11ff7e5",
)
SANGRIA_IVC_K16_STEP = (
    "ae8fb95fa44177d8bb7205c179d4ab71ebc5ce045becf49774c7e1d8b1a0491f",
    "79735c7f55ccf4423913b841aa40a9842b3fe6169f1079b998a59ef66bed3aae",
)

# The lookup path (2- and 3-round SPS), the JAX package run on the CPU,
# frozen.  `plonk_trace_digest` of the K = 5 traces of tests/test_lookup.py
# (RangeCircuit([3, 7, 15, 0, 1, 1, 5]) and VectorRangeCircuit([2, 3, 5, 7,
# 11]), TABLE 16, key CommitmentKey.setup(BN256_G1, 9, b"lookup-test"), a
# fresh bn256 Fq Poseidon transcript each).
LOOKUP_RANGE_K5_TRACE = "c734eedc58d0974a67e4803839b9240441650e869505de475b9ae85943236ae0"
LOOKUP_VECTOR_K5_TRACE = "dfc5a3713a5b06b395dada023430f590a7bf233b84a6a68d6adcffc0681e2f50"
# tests/test_lookup.py::test_fold_with_lookup: RangeCircuit([3, 7, 15]) and
# RangeCircuit([1, 2, 4, 8]) on one transcript, folded into the zero
# relaxed accumulator one after the other: sangria_acc_digest after each.
LOOKUP_SANGRIA_FOLDS = (
    "6da3351b7a0efa15427ccbbd5c21aa923b77ff6ad981128fd569feac1e64aa3b",
    "36a175bcddb5c0a693ffeb48b5dfe97bf1c5eaca6c8e68e276787a56be642828",
)
# tests/test_protogalaxy.py::test_protogalaxy_fibo_lookup_L1:
# FiboXorLookupCircuit(1, 2, 8) at K = 4, XOR_BITS 2, key
# CommitmentKey.setup(BN256_G1, 7, b"pg-test"), bn256 Fr transcripts: the
# trace, the new accumulator and the accumulator after one fold (the
# verifier's instance has the same digest).
LOOKUP_PG_FIBO_XOR_TRACE = "43a1370a4797952ac8b04becad14bedf323cd91171748127b23e70ad03f97142"
LOOKUP_PG_FIBO_XOR_NEW = "01f1066f4fba8153464cbfb19658118b5b374495926ebb717d2eb5643bc20ea9"
LOOKUP_PG_FIBO_XOR_L1 = "8cd8de45127826e9b83ea061c7c38c86cff0c5e90632c42e864cfd05649d016e"
