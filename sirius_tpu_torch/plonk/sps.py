"""Special-soundness protocol: witness commitment rounds + challenges.

Counterpart of `sirius_tpu/plonk/sps.py` for 0 challenges (single gate, no
lookup: commit(advice)) and 1 challenge (several gates, no lookup:
[instances] [C1] ]r1[).  The 2/3-challenge lookup rounds are not ported yet
and raise.  The transcript runs on the host between device commits.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..fields.jfield import Field
from ..ops.poseidon import PoseidonHash
from ..util.ro import NUM_CHALLENGE_BITS
from .structure import PlonkInstance, PlonkStructure, PlonkTrace, PlonkWitness


class SpsError(Exception):
    pass


class ChallengeNotMatch(SpsError):
    def __init__(self, index):
        super().__init__(f"sps challenge mismatch at {index}")


def _absorb_instances(ro: PoseidonHash, instances: Sequence[Sequence[int]]):
    for inst in instances:
        for v in inst:
            ro.absorb_field(v)


def concat_with_padding(f: Field, cols: Sequence[Sequence[int]], n: int, device) -> torch.Tensor:
    """Column-major concatenation, each column padded to n rows, as a
    (len(cols) * n, 8) Montgomery tensor."""
    flat: list[int] = []
    for col in cols:
        flat.extend(col)
        flat.extend([0] * (n - len(col)))
    return f.encode(flat, device)


def run_sps_protocol(S: PlonkStructure, ck, instances, advice, ro_nark: PoseidonHash) -> PlonkTrace:
    """PlonkTrace of a synthesized witness; tensors live on the key's device."""
    f = S.field
    nc = S.num_challenges
    if nc > 1:
        raise SpsError(f"{nc}-challenge (lookup) SPS is not ported")
    W1 = concat_with_padding(f, advice, S.n, ck.device)
    C1 = ck.commit_device(W1)
    challenges = []
    if nc == 1:
        _absorb_instances(ro_nark, instances)
        ro_nark.absorb_point(C1)
        challenges.append(ro_nark.squeeze(NUM_CHALLENGE_BITS))
    return PlonkTrace(PlonkInstance([C1], [list(i) for i in instances], challenges), PlonkWitness([W1]))


def sps_verify(U: PlonkInstance, ro_nark: PoseidonHash) -> None:
    """Re-derive the challenges and compare."""
    if not U.challenges:
        return
    _absorb_instances(ro_nark, U.instances)
    for i, expected in enumerate(U.challenges):
        ro_nark.absorb_point(U.W_commitments[i])
        if ro_nark.squeeze(NUM_CHALLENGE_BITS) != expected:
            raise ChallengeNotMatch(i)
