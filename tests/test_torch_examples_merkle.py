"""The slice's lead path on the CPU: the Merkle-update example
(`sirius_tpu_torch/examples/merkle_tree.py`) at the reference's depth 32,
batch 1, through the Cyclefold driver at k = 17 on mock keys: the example's
`run` (pp, new, verify), then one next and verify, against the JAX
package's run frozen in `util/golden.py` (`MERKLE_D32_B1_K17_*`, made by
`tests/freeze_ivc_digests.py merkle_d32_b1`): the pp digest, z (the tree's
root) and the ProtoGalaxy, support and pending-trace digests after new and
after next.  In a file of its own: the Cyclefold steps take about a minute
here."""

import torch

from sirius_tpu_torch.examples import merkle_tree
from sirius_tpu_torch.util import golden

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers


def _digests(ivc):
    return golden.cyclefold_digests(ivc, [w.numpy() for w in ivc.primary_trace.w.W])


def test_merkle_depth32_batch1_matches_the_frozen_jax_run():
    args = merkle_tree.parser().parse_args(["--cpu", "--fold-steps", "0"])
    assert (args.depth, args.batch, args.k, args.driver) == (32, 1, 17, "cyclefold")
    ivc, t = merkle_tree.run(args)
    assert t["keys"] == "mock" and t["errors"] == []
    assert ivc.pp.digest_hex() == golden.MERKLE_D32_B1_K17_PP
    assert ivc.z_i == [golden.MERKLE_D32_B1_K17_Z[0]] == [ivc.pp.sc.tree.root]
    assert _digests(ivc) == golden.MERKLE_D32_B1_K17_NEW
    ivc.next()
    assert ivc.z_i == [golden.MERKLE_D32_B1_K17_Z[1]] == [ivc.pp.sc.tree.root]
    assert _digests(ivc) == golden.MERKLE_D32_B1_K17_NEXT
    assert ivc.verify() == []
