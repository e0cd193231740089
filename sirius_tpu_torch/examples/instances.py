"""Sangria IVC with a step circuit exposing its own public instances
(reference `examples/instances.rs`; the port's counterpart of
`examples/instances.py`): each step's public values are hash-chained into
the accumulator's `SCInstancesHashAcc`, off- and on-circuit, rather than
folded.

Step: z' = z^5, with z' also exposed in the step circuit's own instance
column each step.

    python -m sirius_tpu_torch.examples.instances [--fold-steps N] [--k K] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass, field

from ._drive import Clock, fold_steps, timed, verify
from ._keys import example_keys, largest_w_round


@dataclass
class PublicPow5Circuit:
    """z_{i+1} = z_i^5, exposed as a public instance (one column, one row)."""

    field_spec: object
    arity: int = 1
    _pub: list = field(default_factory=lambda: [0])

    def configure(self, cs):
        from ..gadgets.main_gate import MainGate

        mg_cfg = MainGate.configure(cs, T=5)
        inst = cs.instance_column()
        return (mg_cfg, inst)

    def instances(self):
        return [list(self._pub)]

    def synthesize_step(self, config, ctx, z_i):
        from ..gadgets.main_gate import MainGate

        mg_cfg, inst = config
        mg = MainGate(mg_cfg, ctx.asn.p)
        out = mg.pow5(ctx, z_i[0])
        ctx.asn.copy(out.column, out.row, inst, 0)
        self._pub = [out.value]
        return [out]

    def process_step(self, z_i, k_table_size, spec):
        out = pow(z_i[0], 5, spec.modulus)
        self._pub = [out]
        return [out]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="instances")
    ap.add_argument("--fold-steps", type=int, default=1)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--cpu", action="store_true")
    return ap


def run(args, keys=None, device=None):
    """pp, new, `args.fold_steps` x fold_step and verify; (ivc, timings)."""
    from ..fields.constants import bn256_fr
    from ..ivc.sangria_ivc import IVC, PublicParams
    from ..ivc.step_circuit import TrivialStepCircuit

    step = PublicPow5Circuit(bn256_fr)
    ck1, ck2, key_kind = keys or example_keys(args.k + 3, args.k + 3, label="instances", cpu=args.cpu, device=device,
                                              holds=largest_w_round(step, args.k, "sangria"))
    print(f"commitment keys: {key_kind}")
    clock = Clock(ck1.device)
    pp, pp_s = timed(clock, lambda: PublicParams(step, TrivialStepCircuit(arity=1),
                                                 args.k, args.k, ck1, ck2))
    print(f"public params: {pp_s:.2f}s (primary sc instance lens: {pp.primary_probe.sc_instance_lens})")
    ivc, new_s = timed(clock, lambda: IVC(pp, [3], [0]))
    print(f"ivc_new: {new_s:.2f}s")
    next_s = fold_steps(clock, ivc.fold_step, args.fold_steps)
    errors, verify_s = verify(clock, ivc)
    return ivc, dict(keys=key_kind, pp_s=pp_s, new_s=new_s, next_s=next_s, verify_s=verify_s, errors=errors)


def main(argv=None) -> int:
    _, t = run(parser().parse_args(argv))
    return 0 if not t["errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
