"""The Sangria folds of the JAX package's multi-device dry run
(`__graft_entry__.py:dryrun_multichip`: two XOR-chain vector-lookup traces
at k = 6, a 3-round SPS, on the key `CommitmentKey.setup(BN256_G1, 9,
b"dryrun-mc")`) in the port under a 4-shard CPU mesh, where every witness
commitment and is_sat's batched check go through `msm_sharded`.  The
accumulator digests after each fold must equal the JAX package's run
without a mesh, frozen in `util/golden.DRYRUN_MC_FOLDS` (its JAX run takes
~90 s on a CPU, so it does not run live; the JAX package's own run under a mesh
is not repeated: its 8-device collectives timed out in `MULTICHIP_r05.json`).
The port without a mesh is held to the same digests in
`test_torch_parallel_commit.py`.  Every W round and E of the folds is row
blocks on the mesh's 4 devices (`parallel/rows.py`)."""

import torch

from sirius_tpu_torch.curves.jpoint import BN256_G1
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.parallel import RowBlocks, make_mesh, mesh_context
from sirius_tpu_torch.util import golden
from sirius_tpu_torch.util.testing import dryrun_sangria_folds

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers


def test_dryrun_folds_under_a_4_shard_mesh_equal_the_jax_package_without_one():
    ck = CommitmentKey.setup(BN256_G1, 9, b"dryrun-mc", use_cache=False, device="cpu")
    mesh = make_mesh(devices=["cpu"] * 4)
    with mesh_context(mesh):
        digests, errors, acc = dryrun_sangria_folds(ck)
    assert errors == []
    assert tuple(digests) == golden.DRYRUN_MC_FOLDS
    assert [m for m, _ in ck.shard_cache] == [mesh] * len(ck.shard_cache)  # the commits went through the mesh's shards
    assert len(acc.W.W) == 3
    for w in [*acc.W.W, acc.W.E]:
        assert isinstance(w, RowBlocks) and w.mesh == mesh and w.devices == list(mesh.devices)
