"""Cyclefold IVC with a Poseidon-hash step circuit (reference
`examples/cyclefold_poseidon.rs`; the port's counterpart of
`examples/cyclefold_poseidon.py`): ProtoGalaxy folding of a multi-gate,
1-challenge primary instance.

    python -m sirius_tpu_torch.examples.cyclefold_poseidon [--fold-steps N] [--repeat-count R] [--k K] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

from ._drive import Clock, fold_steps, timed, verify
from ._keys import example_keys, largest_w_round


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cyclefold_poseidon")
    ap.add_argument("--fold-steps", type=int, default=1)
    ap.add_argument("--repeat-count", type=int, default=1)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--cpu", action="store_true")
    return ap


def run(args, keys=None, device=None):
    """pp, new, `args.fold_steps` x next and verify; (ivc, timings)."""
    from ..fields.constants import bn256_fr
    from ..gadgets.poseidon_step_circuit import PoseidonStepCircuit
    from ..ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams

    step = PoseidonStepCircuit(bn256_fr, repeat_count=args.repeat_count)
    ck1, ck2, key_kind = keys or example_keys(args.k + 3, 17, label="cyclefold-poseidon", cpu=args.cpu,
                                              device=device, holds=largest_w_round(step, args.k))
    print(f"commitment keys: {key_kind}")
    clock = Clock(ck1.device)
    pp, pp_s = timed(clock, lambda: CyclefoldPublicParams(step, args.k, ck1, ck2))
    print(f"public params: {pp_s:.2f}s (gates={pp.n_gates}, challenges={pp.num_challenges_primary})")
    ivc, new_s = timed(clock, lambda: CyclefoldIVC(pp, [0x11]))
    print(f"ivc_new: {new_s:.2f}s")
    next_s = fold_steps(clock, ivc.next, args.fold_steps)
    errors, verify_s = verify(clock, ivc)
    return ivc, dict(keys=key_kind, pp_s=pp_s, new_s=new_s, next_s=next_s, verify_s=verify_s, errors=errors)


def main(argv=None) -> int:
    _, t = run(parser().parse_args(argv))
    return 0 if not t["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
