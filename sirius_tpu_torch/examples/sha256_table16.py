"""Cyclefold IVC folding spread-table SHA-256 compression steps, the
table16-class workload (reference `examples/sha256/main.rs:363-432`; the
port's counterpart of `examples/sha256_table16.py`).

Production configuration: half_bits = 16 (a 2^16-row (dense, spread)
table), a 3-round SPS and 3 support delegations per next.  The default
k = 17 is the JAX example's; `bench.py` runs this step at k = 18 ("the
3-W-commitment SFC needs 2^18 rows"), as `chip_smoke.py` does (`--k 18`).
`--half-bits 8 --k 15` is the small scale.

    python -m sirius_tpu_torch.examples.sha256_table16 [--fold-steps N] [--k K] [--half-bits 8|16] [--rounds R] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

from ._drive import Clock, fold_steps, timed, verify
from ._keys import example_keys, largest_w_round


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="sha256_table16")
    ap.add_argument("--fold-steps", type=int, default=1)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--half-bits", type=int, default=16, choices=(8, 16))
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--cpu", action="store_true")
    return ap


def run(args, keys=None, device=None):
    """pp, new, `args.fold_steps` x next and verify; (ivc, timings)."""
    from ..fields.constants import bn256_fr
    from ..gadgets.spread_sha256 import SpreadSha256StepCircuit
    from ..ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams

    step = SpreadSha256StepCircuit(bn256_fr, half_bits=args.half_bits, rounds=args.rounds)
    ck1, ck2, key_kind = keys or example_keys(args.k + 4, 17, label="sha256-table16", cpu=args.cpu, device=device,
                                              holds=largest_w_round(step, args.k))
    print(f"commitment keys: {key_kind}")
    clock = Clock(ck1.device)
    pp, pp_s = timed(clock, lambda: CyclefoldPublicParams(step, args.k, ck1, ck2))
    print(f"public params ({pp.num_witness_primary} W-commitments/trace): {pp_s:.2f}s")
    ivc, new_s = timed(clock, lambda: CyclefoldIVC(pp, [0x0123456789ABCDEF]))
    print(f"ivc_new: {new_s:.2f}s")
    next_s = fold_steps(clock, ivc.next, args.fold_steps,
                        lambda i, dt: f"ivc_next {i}: {dt:.2f}s  z_i[0]=0x{ivc.z_i[0]:x}")
    errors, verify_s = verify(clock, ivc)
    return ivc, dict(keys=key_kind, pp_s=pp_s, new_s=new_s, next_s=next_s, verify_s=verify_s, errors=errors)


def main(argv=None) -> int:
    _, t = run(parser().parse_args(argv))
    return 0 if not t["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
