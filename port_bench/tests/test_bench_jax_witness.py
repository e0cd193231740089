"""The reference against the JAX package, the code that the port was ported
from and did not write (CPU).

The reference is the verifier's half of the port's own code, frozen, so a
fault of the port's logic would be in the judge too.  These tests hold it to
the JAX package where the CPU reaches:

- each configuration's public-parameter digest, by the reference's own dry
  syntheses, is the JAX package's (frozen in the configuration file; the
  judge checks it in every run as `pp_digest_off`);
- on the trivial configuration at its own k = 17 (mock keys), the program's
  chain after a window, checkpointed in the JAX package's file format, gets
  the same verdict from the JAX package's verifier as from the reference:
  none on the honest chain, errors on both with one pending-witness word
  altered (the control).

The only file of the benchmark that imports the JAX package: it is a test,
and nothing the benchmark runs imports it.
"""

from __future__ import annotations

import pytest

from port_bench import harness
from port_bench.judge import reference_params
from port_bench.tests.chains import SEEDS, alter_pending_witness, judge_chain
from port_bench.tests.doubles import reference_mock_keys


@pytest.mark.parametrize("config", ["cf_trivial_k17", "cf_sha256_k18"])
def test_the_reference_pp_digest_is_the_jax_packages(config):
    cfg = harness.load_config(config)
    assert reference_params(cfg, reference_mock_keys()).digest_hex() == cfg["pp_digest_jax"]


@pytest.fixture(scope="module")
def jax_verifier():
    """`verify(path)`: the JAX package's verdict on a checkpoint of the
    trivial configuration."""
    jax_ckpt = pytest.importorskip("sirius_tpu.util.checkpoint")
    from sirius_tpu.curves.jpoint import BN256_G1, GRUMPKIN
    from sirius_tpu.ivc.cyclefold_ivc import CyclefoldPublicParams
    from sirius_tpu.ivc.step_circuit import TrivialStepCircuit
    from sirius_tpu.util.testing import MockCommitmentKey

    cfg = harness.load_config("cf_trivial_k17")
    jpp = CyclefoldPublicParams(TrivialStepCircuit(arity=1), k=cfg["k"], ck_primary=MockCommitmentKey(BN256_G1),
                                ck_support=MockCommitmentKey(GRUMPKIN))
    assert jpp.digest_hex() == cfg["pp_digest_jax"]
    return lambda path: jax_ckpt.load_cyclefold_state(path, jpp, jpp.digest_hex()).verify()


@pytest.mark.parametrize("control", [False, True], ids=["honest", "control"])
def test_the_reference_and_the_jax_package_agree_on_the_chain(cpu_trivial, honest_chain, jax_verifier, tmp_path,
                                                              control):
    cfg, _, ref_keys, ref_pp = cpu_trivial
    prog, _ = honest_chain
    W0 = prog.ivc.primary_trace.w.W[0]
    path = str(tmp_path / "chain")
    if control:
        alter_pending_witness(W0)
    try:
        prog.ivc.checkpoint(path)
    finally:
        if control:
            alter_pending_witness(W0)  # the word back: the chain is shared
    jax_errors = jax_verifier(path)
    checks, ok = judge_chain(cfg, honest_chain, SEEDS[0], "cpu", ref_keys, ref_pp, control=control)
    assert (checks["verify_errors"] > 0) == bool(jax_errors) == control, (checks, jax_errors)
    assert ok != control
