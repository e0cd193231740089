"""Faults planted under the timed path turn `correct` false, and the honest
path keeps it true.

On the CPU, the trivial k = 17 configuration with the non-binding mock
keys on both sides: the harness's set-up, a window of one call, the
snapshot and the judge, as `run.py` drives them, with the program's next
or SPS broken underneath.  The card's test runs the same on each cell at
its own size on three seeds, with the control: the chain's pending witness
altered in one word after the window.
"""

from __future__ import annotations

import pytest
import torch

from port_bench import harness
from port_bench.tests.chains import SEEDS, chain_after_window as _chain, judge_chain as _judge


def _cpu(cpu_trivial, mix, control=False, fault=None):
    cfg, pp, ref_keys, ref_pp = cpu_trivial
    return _judge(cfg, _chain(cfg, mix, pp, "cpu", SEEDS[0], fault), SEEDS[0], "cpu", ref_keys, ref_pp, control)


def test_honest_steps_are_correct(cpu_trivial, honest_chain):
    cfg, _, ref_keys, ref_pp = cpu_trivial
    checks, ok = _judge(cfg, honest_chain, SEEDS[0], "cpu", ref_keys, ref_pp)
    assert ok and checks["pp_digest_off"] == 0, checks


def test_a_step_that_leaves_the_state_unchanged_is_caught(cpu_trivial, monkeypatch):
    from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldIVC

    monkeypatch.setattr(CyclefoldIVC, "next", lambda self: None)
    checks, ok = _cpu(cpu_trivial, "steps")
    assert not ok and checks["step_off"] >= 1, checks


def test_a_witness_altered_where_the_step_produces_it_is_caught(cpu_trivial, monkeypatch):
    from sirius_tpu_torch.ivc import cyclefold_ivc

    sps = cyclefold_ivc.run_sps_protocol

    def altered(*args, **kwargs):
        trace = sps(*args, **kwargs)
        trace.w.W[0][777, 3] ^= 1
        return trace

    monkeypatch.setattr(cyclefold_ivc, "run_sps_protocol", altered)
    checks, ok = _cpu(cpu_trivial, "steps")
    assert not ok and checks["verify_errors"] >= 1, checks


def test_the_control_fails(cpu_trivial, honest_chain):
    cfg, _, ref_keys, ref_pp = cpu_trivial
    checks, ok = _judge(cfg, honest_chain, SEEDS[0], "cpu", ref_keys, ref_pp, control=True)
    assert not ok and checks["verify_errors"] >= 1, checks


def test_public_parameters_other_than_the_jax_packages_are_caught(cpu_trivial, honest_chain):
    """The reference's pp digest is held to the JAX package's: a structure
    of the reference's that drifted from it, as a configuration whose
    frozen digest is another's, reads 1."""
    cfg, _, ref_keys, ref_pp = cpu_trivial
    other = dict(cfg, pp_digest_jax=harness.load_config("cf_sha256_k18")["pp_digest_jax"])
    checks, ok = _judge(other, honest_chain, SEEDS[0], "cpu", ref_keys, ref_pp)
    assert not ok and checks["pp_digest_off"] == 1, checks


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["cf_trivial_k17.steps", "cf_sha256_k18.steps"])
def test_control_on_the_card(cell):
    """Each cell at its own size on the card, on three seeds: the honest
    window is correct and the control (one witness word altered) is not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    harness.configure_environment()
    bench = harness.load_benchmark()
    w = harness.cell_of(bench, cell)
    cfg = harness.load_config(w["config"])
    device = torch.device("cuda", 0)
    pp, _ = harness.public_params(cfg, device)
    for seed in SEEDS:
        chain = _chain(cfg, w["traffic"], pp, device, seed)
        honest, ok = _judge(cfg, chain, seed, device)
        print(f"{cell} seed {seed}: honest {honest}", flush=True)
        assert ok, honest
        control, ok = _judge(cfg, chain, seed, device, control=True)
        print(f"{cell} seed {seed}: control {control}", flush=True)
        assert not ok, control
