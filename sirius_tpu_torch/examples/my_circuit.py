"""User step-circuit template (reference `examples/my_circuit.rs`; the
port's counterpart of `examples/my_circuit.py`).

The whole surface a user needs for Sangria IVC:
  - a StepCircuit with arity A1 = 5 (vector state z)
  - `configure` registering gadget columns
  - `synthesize_step` building the transition constraints
  - `process_step` mirroring the transition off-circuit
  - PublicParams / IVC driving FOLD_STEP_COUNT folds and verify

The demo transition is z'_j = z_j + z_{(j+1) mod 5}.  The table size is
TABLE_SIZE on both curves and the keys 2^(TABLE_SIZE + 3), as in the JAX
example (whose `main` reads an undefined `args.k` for the key size).

    python -m sirius_tpu_torch.examples.my_circuit [--fold-steps N] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

from ._drive import Clock, fold_steps, timed
from ._keys import example_keys, largest_w_round

FOLD_STEP_COUNT = 2
A1 = 5  # primary state arity
A2 = 1  # secondary (trivial) arity
TABLE_SIZE = 16


class MyStepCircuit:
    arity = A1

    def instances(self):
        return []  # no extra public instance columns

    def configure(self, cs):
        from ..gadgets.main_gate import MainGate

        return MainGate.configure(cs, T=5)

    def synthesize_step(self, config, ctx, z_i):
        from ..gadgets.main_gate import MainGate

        mg = MainGate(config, ctx.asn.p)
        return [mg.add(ctx, z_i[j], z_i[(j + 1) % A1]) for j in range(A1)]

    def process_step(self, z_i, k_table_size, spec):
        return [(z_i[j] + z_i[(j + 1) % A1]) % spec.modulus for j in range(A1)]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="my_circuit")
    ap.add_argument("--fold-steps", type=int, default=FOLD_STEP_COUNT)
    ap.add_argument("--cpu", action="store_true")
    return ap


def run(args, keys=None, device=None):
    """pp, new, `args.fold_steps` x fold_step and verify; (ivc, timings)."""
    from ..ivc.sangria_ivc import IVC, PublicParams
    from ..ivc.step_circuit import TrivialStepCircuit

    step = MyStepCircuit()
    ck1, ck2, key_kind = keys or example_keys(TABLE_SIZE + 3, TABLE_SIZE + 3, label="my-circuit", cpu=args.cpu,
                                              device=device, holds=largest_w_round(step, TABLE_SIZE, "sangria"))
    print(f"commitment keys: {key_kind}")
    clock = Clock(ck1.device)
    pp, pp_s = timed(clock, lambda: PublicParams(step, TrivialStepCircuit(arity=A2), TABLE_SIZE,
                                                 TABLE_SIZE, ck1, ck2))
    ivc, new_s = timed(clock, lambda: IVC(pp, list(range(A1)), [0]))
    print(f"ivc_new: {new_s:.2f}s")
    next_s = fold_steps(clock, ivc.fold_step, args.fold_steps,
                        lambda i, dt: f"ivc_next {i}: {dt:.2f}s  z = {ivc.primary_z_i}")
    errors, verify_s = timed(clock, ivc.verify)
    print("ivc_verify ->", "OK" if not errors else errors)
    return ivc, dict(keys=key_kind, pp_s=pp_s, new_s=new_s, next_s=next_s, verify_s=verify_s, errors=errors)


def main(argv=None) -> int:
    _, t = run(parser().parse_args(argv))
    return 0 if not t["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
