"""The port's entry points (`sirius_tpu_torch/examples/`).

- Every mode of the JAX CLI (`examples/cli.py`, read from its `choices`)
  exists in the port's CLI and hands the port's example the arguments the
  JAX CLI hands the JAX example (`run` stubbed).
- `instances` (a step circuit with its own public instance column, hash-
  chained into `sc_instances_hash_acc`) and `my_circuit` (the arity-5 user
  template), Sangria at K = 16 on mock keys through the examples' `run`:
  pp, new, one fold_step and verify against the JAX package's runs, frozen
  in `util/golden.py` (`SANGRIA_INSTANCES_K16_*`, `MY_CIRCUIT_K16_*`; made by
  `tests/freeze_ivc_digests.py sangria_instances` / `my_circuit`).
- Without `--cpu` every example asks for the card: here it raises.
- On real keys every IVC example's primary key holds its step-folding
  circuit's largest W round, where the JAX example's size (k + 3; k + 4 for
  sha256_table16) is too small for nine of the twelve.
"""

import ast
import importlib
import sys
import types
from argparse import Namespace
from pathlib import Path

import pytest
import torch

from sirius_tpu_torch.examples import cli, instances, my_circuit
from sirius_tpu_torch.util import golden
from sirius_tpu_torch.util.golden import sangria_acc_digest, sangria_ivc_digest

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ["cyclefold_trivial", "merkle_tree", "instances", "my_circuit", "cyclefold_poseidon", "cyclefold_lookup",
            "sha256_table16", "sangria_trivial", "sangria_poseidon", "range_lookup", "xor_lookup", "sha256_ivc",
            "bench_msm", "long_fold"]


def _jax_cli_modes() -> list[str]:
    tree = ast.parse((ROOT / "examples" / "cli.py").read_text())
    choices = next(kw.value for kw in ast.walk(tree) if isinstance(kw, ast.keyword) and kw.arg == "choices")
    return [ast.literal_eval(e) for e in choices.elts]


FLAGS = ["--fold-steps", "3", "--primary-k", "12", "--repeat-count", "2", "--cpu"]
TIMINGS = dict(keys="mock", pp_s=0.0, new_s=0.0, next_s=[], verify_s=0.0, errors=[], peak_bytes=None, spans={})


@pytest.mark.parametrize("mode", _jax_cli_modes())
def test_cli_mode_dispatches_as_the_jax_cli(mode, monkeypatch):
    """The JAX CLI's example (its `main` stubbed) sees some argv; the port's
    CLI must call the same-named example's `run` with what that example's
    own parser makes of the same argv."""
    monkeypatch.syspath_prepend(str(ROOT))
    called = []

    def jax_main(name):
        def main():
            called.append((name, list(sys.argv[1:])))
            return 0
        return main

    jax_modules = ["sangria_trivial", "sangria_poseidon", *cli.SIMPLE.values()]
    for name in jax_modules:
        monkeypatch.setattr(importlib.import_module(f"examples.{name}"), "main", jax_main(name))
    monkeypatch.setitem(sys.modules, "bench", types.SimpleNamespace(main=jax_main("bench")))
    jax_cli = importlib.import_module("examples.cli")
    monkeypatch.setattr(sys, "argv", ["sirius-tpu-cli", mode, *FLAGS])
    jax_cli.main()
    ((jax_name, jax_argv),) = called

    runs = []
    for name in [*jax_modules, "bench_msm"]:
        module = importlib.import_module(f"sirius_tpu_torch.examples.{name}")
        monkeypatch.setattr(module, "run", lambda args, *a, _n=name, **kw: runs.append((_n, args)) or (None, TIMINGS))
    assert cli.main([mode, *FLAGS]) == 0
    ((name, args),) = runs
    if jax_name == "bench":  # the JAX CLI hands bench.py no flag; the port's bench-msm takes --cpu
        assert (name, args) == ("bench_msm", Namespace(cpu=True))
        return
    assert name == jax_name
    port_example = importlib.import_module(f"sirius_tpu_torch.examples.{name}")
    assert args == port_example.parser().parse_args(jax_argv)


def test_sangria_merkle_runs_the_cyclefold_driver(monkeypatch):
    """A hazard kept from the JAX CLI: `sangria-merkle` hands merkle_tree only
    --fold-steps, whose --driver defaults to cyclefold."""
    from sirius_tpu_torch.examples import merkle_tree

    seen = []
    monkeypatch.setattr(merkle_tree, "run", lambda args, *a, **kw: seen.append(args) or (None, TIMINGS))
    monkeypatch.setattr(merkle_tree, "driver_keys", lambda args, device=None: None)
    cli.main(["sangria-merkle", "--cpu"])
    assert seen[0].driver == "cyclefold"


def _sangria_state(ivc):
    return (sangria_acc_digest(ivc.primary_relaxed.U), sangria_acc_digest(ivc.secondary_relaxed.U)), \
        sangria_ivc_digest(ivc)


@pytest.mark.parametrize("example", ["instances", "my_circuit"])
def test_example_matches_the_frozen_jax_run(example, capsys):
    """The example's `run` (pp, new, verify) on the CPU with mock keys, then
    one fold_step and verify, against the JAX package's digests."""
    if example == "instances":
        mod, G = instances, dict(d1=golden.SANGRIA_INSTANCES_K16_PP_DIGEST_1,
                                 d2=golden.SANGRIA_INSTANCES_K16_PP_DIGEST_2, new=golden.SANGRIA_INSTANCES_K16_NEW,
                                 new_state=golden.SANGRIA_INSTANCES_K16_NEW_STATE,
                                 step=golden.SANGRIA_INSTANCES_K16_STEP,
                                 step_state=golden.SANGRIA_INSTANCES_K16_STEP_STATE,
                                 z=[golden.SANGRIA_INSTANCES_K16_Z], sc=golden.SANGRIA_INSTANCES_K16_SC_HASH)
    else:
        mod, G = my_circuit, dict(d1=golden.MY_CIRCUIT_K16_PP_DIGEST_1, d2=golden.MY_CIRCUIT_K16_PP_DIGEST_2,
                                  new=golden.MY_CIRCUIT_K16_NEW, new_state=golden.MY_CIRCUIT_K16_NEW_STATE,
                                  step=golden.MY_CIRCUIT_K16_STEP, step_state=golden.MY_CIRCUIT_K16_STEP_STATE,
                                  z=list(golden.MY_CIRCUIT_K16_Z), sc=None)
    ivc, t = mod.run(mod.parser().parse_args(["--cpu", "--fold-steps", "0"]))
    assert t["keys"] == "mock" and t["errors"] == []
    assert (ivc.pp.digest_coords(1), ivc.pp.digest_coords(2)) == (G["d1"], G["d2"])
    assert _sangria_state(ivc) == (G["new"], G["new_state"])
    if example == "instances":
        assert ivc.pp.primary_probe.sc_instance_lens == (1,)
        assert "(primary sc instance lens: (1,))" in capsys.readouterr().out
    ivc.fold_step()
    assert _sangria_state(ivc) == (G["step"], G["step_state"])
    assert ivc.primary_z_i == G["z"]
    assert ivc.primary_relaxed.U.sc_instances_hash_acc == G["sc"]
    assert ivc.verify() == []


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_without_cpu_asks_for_the_card(example, monkeypatch):
    """No example falls back to the CPU: without --cpu it asks for the CUDA
    device, and where there is none (here, or made so) it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"sirius_tpu_torch.examples.{example}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


# the JAX examples' primary keys at their default k: (k, the key's log size, label, driver); examples/*.py
# `example_keys(args.k + 3, ...)` (sha256_table16 `args.k + 4`), my_circuit's TABLE_SIZE + 3, long_fold's
# scripts/long_fold.py:70 `max(args.k + 3, 14)`, sangria_trivial's --real-commitments `args.k + 3`
JAX_PRIMARY_KEYS = {
    "cyclefold_trivial": (17, 20, b"cyclefold-trivial-primary", "cyclefold", []),
    "cyclefold_poseidon": (17, 20, b"cyclefold-poseidon-primary", "cyclefold", []),
    "cyclefold_lookup": (18, 21, b"cyclefold-lookup-primary", "cyclefold", []),
    "sha256_table16": (18, 22, b"sha256-table16-primary", "cyclefold", ["--k", "18"]),
    "merkle_tree": (17, 20, b"merkle-cf-primary", "cyclefold", []),
    "instances": (16, 19, b"instances-primary", "sangria", []),
    "my_circuit": (16, 19, b"my-circuit-primary", "sangria", []),
    "sangria_trivial": (16, 19, b"sangria-trivial", "sangria", ["--real-commitments"]),
    "sangria_poseidon": (17, 20, b"sangria-poseidon-primary", "sangria", []),
    "range_lookup": (17, 20, b"range-lookup-primary", "sangria", []),
    "xor_lookup": (17, 20, b"xor-lookup-primary", "sangria", []),
    "sha256_ivc": (17, 20, b"sha256-primary", "sangria", []),
    "long_fold": (17, 20, b"bench-primary", "cyclefold", ["--real-keys"]),
}
JAX_KEYS_TOO_SMALL = {"cyclefold_poseidon", "cyclefold_lookup", "merkle_tree", "instances", "my_circuit",
                      "sangria_poseidon", "range_lookup", "xor_lookup", "sha256_ivc"}


class _KeyMade(Exception):
    pass


@pytest.mark.parametrize("example", list(JAX_PRIMARY_KEYS))
def test_example_primary_key_holds_its_largest_w_round(example, monkeypatch):
    """The example's real primary key (its setup intercepted) has the JAX
    example's label and the JAX size, raised to the smallest power of two
    holding the primary step-folding circuit's largest W round (configure
    only: the advice columns times 2^k, and the lookup rounds)."""
    from sirius_tpu_torch.fields.constants import bn256_fr, grumpkin
    from sirius_tpu_torch.frontend.circuit import ConstraintSystemBuilder
    from sirius_tpu_torch.frontend.runner import ConstraintSystemMetainfo
    from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldSFC
    from sirius_tpu_torch.ivc.sangria_ivc import StepFoldingCircuit
    from sirius_tpu_torch.ops.commitment import CommitmentKey

    k, jax_log, label, driver, argv = JAX_PRIMARY_KEYS[example]
    made = []

    def setup(curve, log_n, key_label, *args, **kwargs):
        made.append((curve.spec.name, log_n, key_label))
        raise _KeyMade

    monkeypatch.setattr(CommitmentKey, "setup", staticmethod(setup))
    with pytest.raises(_KeyMade):
        importlib.import_module(f"sirius_tpu_torch.examples.{example}").main(argv)
    ((curve, log_n, key_label),) = made
    assert (curve, key_label) == ("bn256_g1", label)

    sc = _step_circuit(example)
    if driver == "cyclefold":
        sfc = CyclefoldSFC(sc, None, bn256_fr)
    else:
        sfc = StepFoldingCircuit(sc, None, grumpkin, bn256_fr)
    cs = ConstraintSystemBuilder()
    sfc.configure(cs)
    w_round = max(ConstraintSystemMetainfo.build(k, cs).round_sizes)
    assert (1 << log_n) >= w_round and log_n == max(jax_log, (w_round - 1).bit_length())
    assert ((1 << jax_log) < w_round) == (example in JAX_KEYS_TOO_SMALL)


def _step_circuit(example):
    """The step circuit an example folds, at its defaults."""
    from sirius_tpu_torch.fields.constants import bn256_fr
    from sirius_tpu_torch.gadgets.merkle_step_circuit import MerkleStepCircuit
    from sirius_tpu_torch.gadgets.poseidon_step_circuit import PoseidonStepCircuit
    from sirius_tpu_torch.gadgets.range_step_circuit import RangeCheckStepCircuit
    from sirius_tpu_torch.gadgets.sha256_step_circuit import Sha256StepCircuit
    from sirius_tpu_torch.gadgets.spread_sha256 import SpreadSha256StepCircuit
    from sirius_tpu_torch.gadgets.xor_lookup_step_circuit import XorLookupStepCircuit
    from sirius_tpu_torch.gadgets.xor_step_circuit import XorStepCircuit
    from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit

    return {
        "cyclefold_poseidon": lambda: PoseidonStepCircuit(bn256_fr),
        "sangria_poseidon": lambda: PoseidonStepCircuit(bn256_fr),
        "cyclefold_lookup": lambda: XorLookupStepCircuit(key=3),
        "sha256_table16": lambda: SpreadSha256StepCircuit(bn256_fr),
        "merkle_tree": lambda: MerkleStepCircuit(bn256_fr, depth=32),
        "instances": lambda: instances.PublicPow5Circuit(bn256_fr),
        "my_circuit": lambda: my_circuit.MyStepCircuit(),
        "range_lookup": lambda: RangeCheckStepCircuit(bn256_fr),
        "xor_lookup": lambda: XorStepCircuit(bn256_fr),
        "sha256_ivc": lambda: Sha256StepCircuit(bn256_fr),
    }.get(example, lambda: TrivialStepCircuit(arity=1))()
