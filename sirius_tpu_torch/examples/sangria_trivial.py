"""Minimal end-to-end Sangria IVC run (reference
`examples/sangria_trivial.rs`; the port's counterpart of
`examples/sangria_trivial.py`): public parameters for the 2-cycle, IVC new,
a few fold steps, verify, and the `util/profiling` span report.  The
homomorphic mock commitment by default (on the card, or on the CPU with
`--cpu`); `--real-commitments` for the Pedersen keys and the MSM path.

    python -m sirius_tpu_torch.examples.sangria_trivial [--fold-steps N] [--k K] [--real-commitments] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

from ._drive import Clock, fold_steps, timed


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="sangria_trivial")
    ap.add_argument("--fold-steps", type=int, default=1)
    ap.add_argument("--k", type=int, default=16, help="table size (2^k rows)")
    ap.add_argument("--real-commitments", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def _keys(args, device):
    from ..curves.jpoint import BN256_G1, GRUMPKIN

    device = "cpu" if args.cpu else device
    if args.real_commitments:
        from ..ops.commitment import CommitmentKey

        ck1 = CommitmentKey.setup(BN256_G1, args.k + 3, b"sangria-trivial", device=device)
        ck2 = CommitmentKey.setup(GRUMPKIN, args.k + 3, b"sangria-trivial", device=device)
        return ck1, ck2, "real"
    from ..util.testing import MockCommitmentKey

    return MockCommitmentKey(BN256_G1, device), MockCommitmentKey(GRUMPKIN, device), "mock"


def run(args, keys=None, device=None):
    """pp, new, `args.fold_steps` x fold_step and verify under the span
    profiler; (ivc, timings)."""
    from ..ivc.sangria_ivc import IVC, PublicParams
    from ..ivc.step_circuit import TrivialStepCircuit
    from ..util.profiling import profiler, span

    ck1, ck2, key_kind = keys or _keys(args, device)
    clock = Clock(ck1.device)
    was_enabled = profiler.enabled
    profiler.enable()
    try:
        with span("public_params"):
            pp, pp_s = timed(clock, lambda: PublicParams(TrivialStepCircuit(arity=1), TrivialStepCircuit(arity=1),
                                                         args.k, args.k, ck1, ck2))
        with span("ivc_new"):
            ivc, new_s = timed(clock, lambda: IVC(pp, [0x11], [0x22]))

        def fold_step():
            with span("ivc_fold_step"):
                ivc.fold_step()

        next_s = fold_steps(clock, fold_step, args.fold_steps, lambda i, dt: f"fold step {i}: {dt:.2f}s")
        with span("ivc_verify"):
            errors, verify_s = timed(clock, ivc.verify)
        print("verify:", "OK" if not errors else errors)
        profiler.report()
    finally:
        profiler.enabled = was_enabled
    return ivc, dict(keys=key_kind, pp_s=pp_s, new_s=new_s, next_s=next_s, verify_s=verify_s, errors=errors)


def main(argv=None) -> int:
    _, t = run(parser().parse_args(argv))
    return 0 if not t["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
