"""Each example's `main([--cpu, ...])` runs to exit 0 on the CPU at a small
size, printing the JAX example's lines: the examples whose step circuits and
drivers are held against the JAX package elsewhere (`test_torch_cyclefold.py`,
`test_torch_sangria_ivc*.py`, `test_torch_step_circuits.py`), with no fold
step where a step costs most (pp, new and verify), and `long_fold` over two
segments (new, a next, checkpoint, resume from disk, verify).  The lookup
examples (k >= 17: 50-105 s each here without a fold step) and `bench_msm`
(its 2^14 CPU key) are run on the card instead."""

import json

import pytest
import torch

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers

CASES = {
    "cyclefold_trivial": (["--fold-steps", "0"], "ivc_verify: "),
    "cyclefold_poseidon": (["--fold-steps", "0"], "ivc_verify: "),
    "sangria_trivial": (["--fold-steps", "0"], "verify: OK"),
    "sangria_poseidon": (["--fold-steps", "0", "--k", "16"], "ivc_verify: "),
    "sha256_ivc": (["--fold-steps", "0"], "ivc_verify: "),
    "long_fold": (["--steps", "2", "--segments", "2"], None),
}


@pytest.mark.parametrize("example", list(CASES))
def test_example_main_runs_on_the_cpu(example, capsys, tmp_path):
    import importlib

    argv, last = CASES[example]
    module = importlib.import_module(f"sirius_tpu_torch.examples.{example}")
    if example == "long_fold":
        argv = [*argv, "--ckpt", str(tmp_path / "ckpt")]
    assert module.main(["--cpu", *argv]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    if example == "long_fold":
        result = json.loads(out[-1])
        assert result["verify_errors"] == [] and len(result["resume_s"]) == 2
        segments = [json.loads(line) for line in (tmp_path / "long_fold.jsonl").read_text().splitlines()]
        assert [s.get("steps_done") for s in segments] == [2, 2, None]
        return
    assert out[0] == "commitment keys: mock" or example == "sangria_trivial"
    verify_line = next(line for line in out if line.startswith(last.split(":")[0] + ":"))
    assert verify_line.startswith(last) and verify_line.endswith("OK")
