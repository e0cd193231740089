"""IVC proving a chain of Poseidon Merkle-tree updates (reference
`examples/merkle/`, a depth-32 tree, the Cyclefold driver; BASELINE.md rows
"Merkle update, batch 1..5"; the port's counterpart of
`examples/merkle_tree.py`).  Each step witnesses `batch` authentication
paths, proves old root == z_i and advances to the new root.

`--sweep` runs batch 1..5 and prints them beside the reference's EPYC 7702
seconds (`docs/cyclefold_report.md:205-209`, the Rust reference on a 64-core
CPU).  On the card each batch also prints its peak device memory, and with
the span profiler on (SIRIUS_TPU_PROFILE=1) the host seconds of its spans.

    python -m sirius_tpu_torch.examples.merkle_tree [--fold-steps N] [--depth D] [--batch B] [--k K]
        [--driver cyclefold|sangria] [--sweep] [--cpu]
"""

from __future__ import annotations

import argparse
import copy
import sys

from ._drive import Clock, peak_bytes, peak_reset, span_totals, timed
from ._keys import example_keys, largest_w_round

# docs/cyclefold_report.md:205-209 (EPYC 7702 64c): ivc_new, ivc_next, ivc_verify seconds
BASELINE = {
    1: (24.7, 16.4, 3.98),
    2: (30.0, 19.5, 3.97),
    3: (35.7, 22.4, 4.01),
    4: (41.7, 25.7, 4.19),
    5: (47.8, 28.7, 4.35),
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="merkle_tree")
    ap.add_argument("--fold-steps", type=int, default=1)
    ap.add_argument("--depth", type=int, default=32)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--driver", choices=("cyclefold", "sangria"), default="cyclefold")
    ap.add_argument("--sweep", action="store_true", help="batch 1..5 comparison table")
    ap.add_argument("--cpu", action="store_true")
    return ap


def driver_keys(args, device=None):
    """The keys of `args.driver`: the JAX example's labels and sizes, the
    primary raised to hold the step-folding circuit's largest W round (its
    columns times 2^k, whatever the batch)."""
    from ..fields.constants import bn256_fr
    from ..gadgets.merkle_step_circuit import MerkleStepCircuit

    holds = largest_w_round(MerkleStepCircuit(bn256_fr, depth=args.depth, batch=args.batch), args.k,
                            args.driver)
    if args.driver == "sangria":
        return example_keys(args.k + 3, args.k + 3, label="merkle", cpu=args.cpu, device=device, holds=holds)
    return example_keys(args.k + 3, 17, label="merkle-cf", cpu=args.cpu, device=device, holds=holds)


def run(args, keys=None, device=None):
    """pp, new, `args.fold_steps` steps and verify at `args.batch`;
    (ivc, timings: keys, pp_s, new_s, next_s (a list), verify_s, errors,
    peak_bytes (None on the CPU), spans)."""
    from ..fields.constants import bn256_fr
    from ..gadgets.merkle_step_circuit import MerkleStepCircuit

    sc = MerkleStepCircuit(bn256_fr, depth=args.depth, batch=args.batch)
    ck1, ck2, kind = keys or driver_keys(args, device)
    clock = Clock(ck1.device)
    peak_reset(ck1.device)
    span_totals()
    if args.driver == "sangria":
        from ..ivc.sangria_ivc import IVC, PublicParams
        from ..ivc.step_circuit import TrivialStepCircuit

        pp, pp_s = timed(clock, lambda: PublicParams(sc, TrivialStepCircuit(arity=1), args.k, args.k, ck1, ck2))
        ivc, new_s = timed(clock, lambda: IVC(pp, [sc.tree.root], [0]))
        step = ivc.fold_step
    else:
        from ..ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams

        pp, pp_s = timed(clock, lambda: CyclefoldPublicParams(sc, args.k, ck1, ck2))
        ivc, new_s = timed(clock, lambda: CyclefoldIVC(pp, [sc.tree.root]))
        step = ivc.next
    next_s = [timed(clock, step)[1] for _ in range(args.fold_steps)]
    errors, verify_s = timed(clock, ivc.verify)
    return ivc, dict(keys=kind, pp_s=pp_s, new_s=new_s, next_s=next_s, verify_s=verify_s, errors=errors,
                     peak_bytes=peak_bytes(ck1.device), spans=span_totals())


def _detail(r) -> str:
    """The peak device memory and span seconds of a run, where measured."""
    parts = []
    if r["peak_bytes"] is not None:
        parts.append(f"peak device memory {r['peak_bytes']} B ({r['peak_bytes'] / 2**30:.3f} GiB)")
    if r["spans"]:
        parts.append("spans: " + ", ".join(f"{k} {v:.4f}s" for k, v in r["spans"].items()))
    return "  " + "; ".join(parts) if parts else ""


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    keys = driver_keys(args)
    if not args.sweep:
        _, r = run(args, keys)
        print(f"keys: {r['keys']}  pp: {r['pp_s']:.2f}s")
        print(f"ivc_new: {r['new_s']:.2f}s  ivc_next: {min(r['next_s'], default=0.0):.2f}s  "
              f"ivc_verify: {r['verify_s']:.2f}s")
        if _detail(r):
            print(_detail(r))
        if r["errors"]:
            print(f"verify: {r['errors']}")
        return 0 if not r["errors"] else 1

    print("batch | ivc_new (ref)    | ivc_next (ref)   | ivc_verify (ref)")
    failed = False
    for batch in range(1, 6):
        one = copy.copy(args)
        one.batch = batch
        _, r = run(one, keys)
        bn, bx, bv = BASELINE[batch]
        print(f"{batch:5d} | {r['new_s']:7.2f} ({bn:6.1f}) | {min(r['next_s'], default=0.0):7.2f} ({bx:6.1f}) | "
              f"{r['verify_s']:7.2f} ({bv:5.2f})", flush=True)
        if _detail(r):
            print(f"{_detail(r)}; pp {r['pp_s']:.2f}s", flush=True)
        if r["errors"]:
            print(f"verify at batch {batch}: {r['errors']}")
            failed = True
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
