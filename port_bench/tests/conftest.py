"""Fixtures of the benchmark's CPU tests: the trivial configuration at its
own k = 17 on the non-binding mock keys, and one honest chain on it."""

from __future__ import annotations

import pytest

from port_bench import harness
from port_bench.judge import reference_params
from port_bench.tests.chains import SEEDS, chain_after_window
from port_bench.tests.doubles import program_mock_keys, reference_mock_keys


@pytest.fixture(scope="session")
def cpu_trivial():
    """(configuration, the program's pp, the reference's keys, the reference's pp)."""
    harness.configure_environment()
    cfg = harness.load_config("cf_trivial_k17")
    pp, _ = harness.public_params(cfg, "cpu", program_mock_keys())
    ref_keys = reference_mock_keys()
    return cfg, pp, ref_keys, reference_params(cfg, ref_keys)


@pytest.fixture(scope="session")
def honest_chain(cpu_trivial):
    """(program, snapshot) of new, one next and a window of one next."""
    cfg, pp, _, _ = cpu_trivial
    return chain_after_window(cfg, "steps", pp, "cpu", SEEDS[0])
