"""CLI driver (reference `examples/cli.rs`; the port's counterpart of
`examples/cli.py`): choose the IVC mode, table size, fold-step count and
profiling output.

    python -m sirius_tpu_torch.examples.cli <mode> [--fold-steps N] [--primary-k K] [--repeat-count R]
        [--cpu] [--profile-json FILE]

Each mode calls its example's `main` with the flags the JAX CLI hands its
example.  As there, `sangria-merkle` runs `merkle_tree` with its default
driver, which is Cyclefold, and `--primary-k` reaches only
`sangria-trivial` and `sangria-poseidon`.  `bench-msm` times the port's
MSM (`bench_msm.py`), on the CPU when given `--cpu` (the JAX CLI hands
`bench.py` no flag).  `--profile-json` turns the
`util/profiling` spans on and, at the end of the run, appends each span to
FILE as a JSON line.
"""

from __future__ import annotations

import argparse
import importlib
import sys

# the modes that hand their example only --fold-steps (and --cpu)
SIMPLE = {
    "sangria-instances": "instances",
    "sangria-merkle": "merkle_tree",
    "sangria-range-lookup": "range_lookup",
    "sangria-xor-lookup": "xor_lookup",
    "cyclefold-trivial": "cyclefold_trivial",
    "cyclefold-poseidon": "cyclefold_poseidon",
    "cyclefold-lookup": "cyclefold_lookup",
}
MODES = ["sangria-trivial", "sangria-poseidon", *SIMPLE, "bench-msm"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="sirius-tpu-cli")
    ap.add_argument("mode", choices=MODES, help="which pipeline to run")
    ap.add_argument("--fold-steps", type=int, default=1)
    ap.add_argument("--primary-k", type=int, default=16)
    ap.add_argument("--repeat-count", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--profile-json", type=str, default=None,
                    help="append span JSON lines to this file at the end of the run (reference tracing-json analogue)")
    return ap


def dispatch(args) -> tuple[str, list[str]]:
    """(example module name, the argv its `main` gets) for a mode."""
    cpu = ["--cpu"] if args.cpu else []
    if args.mode == "sangria-trivial":
        return "sangria_trivial", ["--fold-steps", str(args.fold_steps), "--k", str(args.primary_k), *cpu]
    if args.mode == "sangria-poseidon":
        return "sangria_poseidon", ["--fold-steps", str(args.fold_steps), "--k", str(args.primary_k),
                                    "--repeat-count", str(args.repeat_count), *cpu]
    if args.mode in SIMPLE:
        return SIMPLE[args.mode], ["--fold-steps", str(args.fold_steps), *cpu]
    return "bench_msm", cpu


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from ..util.profiling import profiler

    if args.profile_json:
        profiler.enable()
        profiler.json_path = args.profile_json
    name, example_argv = dispatch(args)
    try:
        return importlib.import_module(f"{__package__}.{name}").main(example_argv)
    finally:
        if args.profile_json:
            profiler.write_json()


if __name__ == "__main__":
    sys.exit(main())
