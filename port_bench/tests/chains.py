"""Chains for the benchmark's CPU tests: the harness's set-up and a window
of one call, as `run.py` drives them, and the judge over what they leave."""

from __future__ import annotations

from port_bench import harness
from port_bench.judge import judge

SEEDS = (2**31 + 4242, 2**31 + 917, 3_000_000_017)


def chain_after_window(cfg, mix, pp, device, seed, fault=None):
    """(program, snapshot) after the mix's set-up and a window of one call
    (`fault`, when given, is planted between the two)."""
    traffic = harness.load_traffic(mix)
    prog = harness.start_chain(pp, cfg, traffic, seed, device)
    if fault is not None:
        fault()
    harness.window(prog, traffic["op"], 0.0)
    return prog, harness.snapshot(prog.ivc)


def alter_pending_witness(W0):
    """The control: one word of the pending trace's first round changed, in place."""
    W0[12345, 0] ^= 1


def judge_chain(cfg, chain, seed, device, ref_keys=None, ref_pp=None, control=False):
    """({check: value}, correct) of a chain; `control` judges a copy with
    the pending witness altered after the window."""
    prog, state = chain
    if control:
        state = dict(state, pri_W=[w.clone() for w in state["pri_W"]])
        alter_pending_witness(state["pri_W"][0])
    checks = judge(cfg, state, prog.z0, 1 + prog.ops_done, seed, device, keys=ref_keys, pp=ref_pp)
    return {c.name: c.value for c in checks}, all(c.ok for c in checks)
