"""Sangria IVC with a lookup-using step circuit (the port's counterpart of
`examples/range_lookup.py`): z' = low64(z^2 + z + 5) with byte-table range
checks, a 2-round SPS (2 witness commitments, 2 challenges) folded through
the 2-cycle.

    python -m sirius_tpu_torch.examples.range_lookup [--fold-steps N] [--k K] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

from ._drive import Clock, fold_steps, timed, verify
from ._keys import example_keys, largest_w_round


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="range_lookup")
    ap.add_argument("--fold-steps", type=int, default=1)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--cpu", action="store_true")
    return ap


def run(args, keys=None, device=None):
    """pp, new, `args.fold_steps` x fold_step and verify; (ivc, timings)."""
    from ..fields.constants import bn256_fr
    from ..gadgets.range_step_circuit import RangeCheckStepCircuit
    from ..ivc.sangria_ivc import IVC, PublicParams
    from ..ivc.step_circuit import TrivialStepCircuit

    step = RangeCheckStepCircuit(bn256_fr)
    ck1, ck2, key_kind = keys or example_keys(args.k + 3, args.k + 3, label="range-lookup", cpu=args.cpu, device=device,
                                              holds=largest_w_round(step, args.k, "sangria"))
    print(f"commitment keys: {key_kind}")
    clock = Clock(ck1.device)
    pp, pp_s = timed(clock, lambda: PublicParams(step, TrivialStepCircuit(arity=1), args.k, args.k, ck1, ck2))
    print(f"public params: {pp_s:.2f}s (primary probe: ct={pp.primary_probe.num_cross_terms}, "
          f"nc={pp.primary_probe.num_challenges}, nw={pp.primary_probe.num_witness})")
    ivc, new_s = timed(clock, lambda: IVC(pp, [7], [0]))
    print(f"ivc_new: {new_s:.2f}s")
    next_s = fold_steps(clock, ivc.fold_step, args.fold_steps)
    errors, verify_s = verify(clock, ivc)
    return ivc, dict(keys=key_kind, pp_s=pp_s, new_s=new_s, next_s=next_s, verify_s=verify_s, errors=errors)


def main(argv=None) -> int:
    _, t = run(parser().parse_args(argv))
    return 0 if not t["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
