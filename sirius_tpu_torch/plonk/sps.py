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

The transcript runs on the host between device commits; the lookup vectors
stay on the key's device (`plonk/lookup.py`).  Under the row mesh of n
(`parallel/rows.row_mesh`) every round is row blocks: a replayed witness
uploads each block's rows of every column to its device and converts them
there, direct synthesis encodes and then cuts by table rows, and the
lookup rounds come out of their passes as row blocks.  One lookup argument at most:
with several, the JAX package writes them one after another (l0, l1, ..,
t0, ..) while its witness index map and log-derivative check read them
interleaved (l0, t0, m0, l1, ..); the port raises rather than inherit that.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..fields.jfield import Field
from ..frontend.taped import ReplayedWitness
from ..ops.poseidon import PoseidonHash
from ..parallel.mesh import Mesh
from ..parallel.rows import RowBlocks, cat, row_mesh
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


def concat_with_padding(f: Field, cols: Sequence[Sequence[int]], n: int, device, mesh: Mesh | None = None):
    """Column-major concatenation, each column padded to n rows, as a
    (len(cols) * n, 8) Montgomery tensor.  A tape replay's columns
    (`ReplayedWitness`: (n, 8) u32 standard-form words) are concatenated on
    the host, uploaded as 32 bytes a value and converted to Montgomery form
    on the device (`Field.to_mont_words`); int columns (direct synthesis)
    are encoded on the host.  Given a mesh, the round as its row blocks: a
    replay's block rows of every column go straight to the block's device
    and convert there (one `mul_rows` a block)."""
    if mesh is not None and isinstance(cols, ReplayedWitness):
        nb = n // mesh.size
        if any(c.shape[0] != n for c in cols.cols):
            raise SpsError(f"replayed witness columns of {[c.shape[0] for c in cols.cols]} rows, expected {n}")
        return RowBlocks(mesh, n, len(cols), [
            f.to_mont_words(torch.from_numpy(np.concatenate([c[d * nb : (d + 1) * nb] for c in cols.cols])
                                             .view(np.int32)).to(dev))
            for d, dev in enumerate(mesh.devices)])
    if mesh is not None:
        return RowBlocks.shard(mesh, concat_with_padding(f, cols, n, device), n)
    if isinstance(cols, ReplayedWitness):
        arr = np.concatenate(cols.cols, axis=0)
        if arr.shape[0] != len(cols) * n:
            raise SpsError(f"replayed witness has {arr.shape[0]} rows, expected {len(cols)} x {n}")
        return f.to_mont_words(torch.from_numpy(arr.view(np.int32)).to(device))
    flat: list[int] = []
    for col in cols:
        flat.extend(col)
        flat.extend([0] * (n - len(col)))
    return f.encode(flat, device)


def _commit_and_squeeze(ck, ro_nark: PoseidonHash, W) -> tuple:
    C = ck.commit_device(W)
    ro_nark.absorb_point(C)
    return C, ro_nark.squeeze(NUM_CHALLENGE_BITS)


def run_sps_protocol(S: PlonkStructure, ck, instances, advice, ro_nark: PoseidonHash) -> PlonkTrace:
    """PlonkTrace of a synthesized witness; tensors live on the key's device,
    or as row blocks on the row mesh of n."""
    f = S.field
    nc = S.num_challenges
    if nc > 3:
        raise SpsError(f"unsupported challenge count {nc}")
    la = S.lookup_arguments
    if nc >= 2 and la is None:
        raise SpsError("lookup arguments required for >=2 challenges")
    if nc >= 2 and la.num_lookups() > 1:
        raise SpsError(f"{la.num_lookups()} lookup arguments: the rounds hold one (see the module docstring)")
    adv = concat_with_padding(f, advice, S.n, ck.device, row_mesh(S.n))
    insts = [list(i) for i in instances]
    if nc == 0:
        return PlonkTrace(PlonkInstance([ck.commit_device(adv)], insts, []), PlonkWitness([adv]))
    if nc == 1:
        _absorb_instances(ro_nark, instances)
        C1, r1 = _commit_and_squeeze(ck, ro_nark, adv)
        return PlonkTrace(PlonkInstance([C1], insts, [r1]), PlonkWitness([adv]))
    if nc == 2:
        c1 = la.evaluate_coefficient_1(S, adv, 0)
        W1 = cat([adv, *c1.ls, *c1.ts, *c1.ms])
        _absorb_instances(ro_nark, instances)
        C1, r1 = _commit_and_squeeze(ck, ro_nark, W1)
        c2 = c1.evaluate_coefficient_2(r1)
        W2 = cat([*c2.hs, *c2.gs])
        C2, r2 = _commit_and_squeeze(ck, ro_nark, W2)
        return PlonkTrace(PlonkInstance([C1, C2], insts, [r1, r2]), PlonkWitness([W1, W2]))
    _absorb_instances(ro_nark, instances)
    C1, r1 = _commit_and_squeeze(ck, ro_nark, adv)
    c1 = la.evaluate_coefficient_1(S, adv, r1)
    W2 = cat([*c1.ls, *c1.ts, *c1.ms])
    C2, r2 = _commit_and_squeeze(ck, ro_nark, W2)
    c2 = c1.evaluate_coefficient_2(r2)
    W3 = cat([*c2.hs, *c2.gs])
    C3, r3 = _commit_and_squeeze(ck, ro_nark, W3)
    return PlonkTrace(PlonkInstance([C1, C2, C3], insts, [r1, r2, r3]), PlonkWitness([adv, W2, W3]))


def sps_verify(U: PlonkInstance, ro_nark: PoseidonHash) -> None:
    """Re-derive the challenges and compare."""
    if not U.challenges:
        return
    _absorb_instances(ro_nark, U.instances)
    for i, expected in enumerate(U.challenges):
        ro_nark.absorb_point(U.W_commitments[i])
        if ro_nark.squeeze(NUM_CHALLENGE_BITS) != expected:
            raise ChallengeNotMatch(i)
