"""Commitments under an active mesh (`parallel/context.py`): inside
`mesh_context`, `CommitmentKey.commit_device` and `batched_commit_check`
cut the scalars and the key by rows over the mesh (`ops/msm.msm_sharded`)
and must give their results outside it, on the dry run's real key
(`CommitmentKey.setup(BN256_G1, 9, b"dryrun-mc")`, as
`__graft_entry__.py:dryrun_multichip` sets it up).  Then the dry run's
Sangria folds without a mesh against the JAX package's digests frozen in
`util/golden.DRYRUN_MC_FOLDS`: the control of
`test_torch_parallel_folds.py`, which runs them under a 4-shard mesh."""

import numpy as np
import pytest
import torch

from sirius_tpu_torch.curves.jpoint import BN256_G1
from sirius_tpu_torch.fields.jfield import FR
from sirius_tpu_torch.ops import msm as msm_mod
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.parallel import make_mesh, mesh_context
from sirius_tpu_torch.util import golden
from sirius_tpu_torch.util.testing import dryrun_sangria_folds

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers


@pytest.fixture(scope="module")
def ck():
    return CommitmentKey.setup(BN256_G1, 9, b"dryrun-mc", use_cache=False, device="cpu")


def _w(rng, n):
    return FR.encode([int(x) for x in rng.integers(0, 2**62, size=n)], "cpu")


def test_commit_device_and_batched_commit_check_under_a_mesh_equal_their_results_outside(ck, monkeypatch):
    rng = np.random.default_rng(9)
    W1, W2 = _w(rng, 192), _w(rng, 100)  # a k = 6 round of 3 advice columns, and a ragged one
    C1, C2 = ck.commit_device(W1), ck.commit_device(W2)
    good, bad = [(W1, C1), (W2, C2)], [(W1, C2)]
    outside = (ck.batched_commit_check(good), ck.batched_commit_check(bad))
    assert outside == ([], [0])
    calls = []
    real = msm_mod.msm_sharded
    monkeypatch.setattr(msm_mod, "msm_sharded", lambda *a: calls.append(a[3]) or real(*a))
    mesh = make_mesh(devices=["cpu"] * 4)
    with mesh_context(mesh):
        assert (ck.commit_device(W1), ck.commit_device(W2)) == (C1, C2)
        assert (ck.batched_commit_check(good), ck.batched_commit_check(bad)) == outside
    assert calls == [mesh] * 4
    # the key's shards are placed once per (mesh, n), views of the key's own rows on its device
    assert set(ck.shard_cache) == {(mesh, 192), (mesh, 100)}
    shards = ck.shard_cache[(mesh, 192)]
    assert [s.x.shape[0] for s in shards] == [48] * 4
    assert all(s.x.data_ptr() == ck.points.x[48 * i:].data_ptr() for i, s in enumerate(shards))
    with mesh_context(make_mesh(devices=["cpu"])):  # a mesh of one entry: the single-device path
        assert ck.commit_device(W2) == C2
    assert len(calls) == 4


def test_dryrun_folds_without_a_mesh_equal_the_jax_package(ck):
    digests, errors, _ = dryrun_sangria_folds(ck)
    assert errors == []
    assert tuple(digests) == golden.DRYRUN_MC_FOLDS
