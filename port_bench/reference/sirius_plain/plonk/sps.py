"""Special-soundness protocol: witness commitment rounds + challenges.

Counterpart of `sirius_tpu/plonk/sps.py` (reference `src/plonk/mod.rs:402-663`
and `src/sps.rs`).  Round count = num_challenges (0..3):

  0: single gate, no lookup:     commit(advice)
  1: several gates, no lookup:   [instances] [C1] ]r1[
  2: lookup, no vector lookup:   W1 = advice ++ (l, t, m) at r = 0;
                                 [instances] [C1] ]r1[, W2 = (h, g) at r1,
                                 [C2] ]r2[
  3: vector lookup:              [instances], W1 = advice, [C1] ]r1[,
                                 W2 = (l, t, m) at r1, [C2] ]r2[,
                                 W3 = (h, g) at r2, [C3] ]r3[

The verifier's half: `sps_verify` re-derives the challenges of a trace's
instance from its instances and round commitments.  The prover's rounds
(`run_sps_protocol`) are left out.
"""

from __future__ import annotations

from typing import Sequence

from ..ops.poseidon import PoseidonHash
from ..util.ro import NUM_CHALLENGE_BITS
from .structure import PlonkInstance


class SpsError(Exception):
    pass


class ChallengeNotMatch(SpsError):
    def __init__(self, index):
        super().__init__(f"sps challenge mismatch at {index}")


def _absorb_instances(ro: PoseidonHash, instances: Sequence[Sequence[int]]):
    for inst in instances:
        for v in inst:
            ro.absorb_field(v)


def sps_verify(U: PlonkInstance, ro_nark: PoseidonHash) -> None:
    """Re-derive the challenges and compare."""
    if not U.challenges:
        return
    _absorb_instances(ro_nark, U.instances)
    for i, expected in enumerate(U.challenges):
        ro_nark.absorb_point(U.W_commitments[i])
        if ro_nark.squeeze(NUM_CHALLENGE_BITS) != expected:
            raise ChallengeNotMatch(i)
