"""Long-fold endurance run: N Cyclefold steps through checkpoint and resume
(the port's counterpart of `scripts/long_fold.py`).

Runs `--steps` Cyclefold IVC steps in `--segments` segments.  Each segment
after the first re-enters through `CyclefoldIVC.resume` from the checkpoint
on disk (the previous IVC object is deleted first), the path a long fold
takes after a preemption.  At the end the IVC resumed from the last
checkpoint must verify clean; prints one JSON line (seconds per step:
median, min, max; resume, checkpoint and verify seconds; the checkpoint's
bytes) and appends per-segment JSON lines to `--out`.

Mock commitment keys (the homomorphic s * G) by default, on the card or,
with `--cpu`, on the CPU; `--real-keys` for Pedersen keys on the card
(b"bench-primary" 2^max(k + 3, 14), or larger where the step-folding
circuit's W round needs it, and b"bench-support" 2^17).  Either way the
whole protocol runs: ProtoGalaxy prove and fold, the support Sangria folds,
the step-folding circuit's synthesis, the transcripts and markers.

    python -m sirius_tpu_torch.examples.long_fold --steps 32 --segments 4 --real-keys
    python -m sirius_tpu_torch.examples.long_fold --steps 4 --segments 2 --cpu
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

from ._drive import Clock, timed


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="long_fold")
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--segments", type=int, default=2)
    ap.add_argument("--k", type=int, default=17)
    ap.add_argument("--step-circuit", default="trivial", choices=["trivial", "poseidon"])
    ap.add_argument("--real-keys", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path prefix (default: <temporary directory>/sirius_tpu_torch_long_fold/ckpt)")
    ap.add_argument("--out", default=None, help="per-segment JSON lines (default: long_fold.jsonl beside --ckpt)")
    ap.add_argument("--verify-every-segment", action="store_true",
                    help="run the full verify() at each segment boundary, not just the end")
    return ap


def _keys(args, step, device):
    from ..curves.jpoint import BN256_G1, GRUMPKIN
    from ..ivc.support_fold import SUPPORT_K
    from ._keys import largest_w_round

    device = "cpu" if args.cpu else device
    if args.real_keys:
        from ..ops.commitment import CommitmentKey

        # the JAX script's 2^max(k + 3, 14), raised where the step-folding circuit's W round needs more (the
        # Poseidon step's at k = 17: 1,835,008 scalars)
        k1 = max(args.k + 3, 14, (largest_w_round(step, args.k) - 1).bit_length())
        ck1 = CommitmentKey.setup(BN256_G1, k1, b"bench-primary", device=device)
        ck2 = CommitmentKey.setup(GRUMPKIN, SUPPORT_K + 3, b"bench-support", device=device)
        return ck1, ck2, "real"
    from ..util.testing import MockCommitmentKey

    return MockCommitmentKey(BN256_G1, device), MockCommitmentKey(GRUMPKIN, device), "mock"


def _bytes(path: str) -> int:
    return sum(os.path.getsize(path + ext) for ext in (".json", ".npz"))


def run(args, keys=None, device=None):
    """The whole run; (the IVC resumed from the last checkpoint, the result
    dict that `main` prints)."""
    from ..fields.constants import bn256_fr
    from ..ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams
    from ..ivc.step_circuit import TrivialStepCircuit

    t_start = time.perf_counter()

    def log(msg):
        print(f"[long_fold +{time.perf_counter() - t_start:8.1f}s] {msg}", file=sys.stderr, flush=True)

    ckpt = args.ckpt or os.path.join(tempfile.gettempdir(), "sirius_tpu_torch_long_fold", "ckpt")
    out = args.out or os.path.join(os.path.dirname(os.path.abspath(ckpt)), "long_fold.jsonl")
    if args.step_circuit == "trivial":
        sc = TrivialStepCircuit(arity=1)
    else:
        from ..gadgets.poseidon_step_circuit import PoseidonStepCircuit

        sc = PoseidonStepCircuit(bn256_fr, repeat_count=1)
    ck1, ck2, key_kind = keys or _keys(args, sc, device)
    clock = Clock(ck1.device)
    log(f"keys ready ({key_kind}, {ck1.device})")
    pp, pp_s = timed(clock, lambda: CyclefoldPublicParams(sc, args.k, ck1, ck2))
    log(f"pp built in {pp_s:.1f}s")

    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    seg_sizes = [args.steps // args.segments] * args.segments
    seg_sizes[-1] += args.steps - sum(seg_sizes)
    step_s, resume_s, checkpoint_s = [], [], []
    steps_done = 0
    for seg, seg_steps in enumerate(seg_sizes):
        if seg == 0:
            ivc, new_s = timed(clock, lambda: CyclefoldIVC(pp, [0x42]))
            steps_done = 1  # new performs the first step (the step counter is 1)
            log(f"segment 0: new() in {new_s:.1f}s")
        else:
            ivc, dt = timed(clock, lambda: CyclefoldIVC.resume(pp, ckpt))
            resume_s.append(dt)
            log(f"segment {seg}: resumed at step {ivc.step} in {dt:.2f}s")
            if ivc.step != steps_done:
                raise RuntimeError(f"resumed at step {ivc.step}, expected {steps_done}")

        t_seg = clock()
        target = min(steps_done + seg_steps, args.steps) if seg < args.segments - 1 else args.steps
        while ivc.step < target:
            _, dt = timed(clock, ivc.next)
            step_s.append(dt)
            steps_done = ivc.step
            if steps_done % 32 == 0 or steps_done <= 4:
                log(f"step {steps_done}/{args.steps} ({dt:.2f}s/step, avg {sum(step_s) / len(step_s):.2f})")
        seg_s = clock() - t_seg

        _, dt = timed(clock, lambda: ivc.checkpoint(ckpt))
        checkpoint_s.append(dt)
        seg_rec = {"segment": seg, "steps_done": steps_done, "segment_s": round(seg_s, 2),
                   "checkpoint_s": round(dt, 3), "checkpoint_bytes": _bytes(ckpt), "z_i": [hex(v) for v in ivc.z_i]}
        if seg:
            seg_rec["resume_s"] = round(resume_s[-1], 3)
        if args.verify_every_segment:
            errors, dt = timed(clock, ivc.verify)
            seg_rec["verify_s"] = round(dt, 2)
            seg_rec["verify_errors"] = [str(e) for e in errors]
            if errors:
                raise RuntimeError(f"verify at segment {seg}: {errors}")
        with open(out, "a") as f:
            f.write(json.dumps(seg_rec) + "\n")
        log(f"segment {seg} checkpointed at step {steps_done}")
        del ivc  # the next segment must resume from the state on disk

    ivc, dt = timed(clock, lambda: CyclefoldIVC.resume(pp, ckpt))
    resume_s.append(dt)
    errors, verify_s = timed(clock, ivc.verify)
    result = {
        "metric": f"cyclefold_{args.step_circuit}_k{args.k}_long_fold",
        "steps": args.steps,
        "segments": args.segments,
        "real_keys": args.real_keys,
        "device": str(ck1.device),
        "amortized_next_s": round(sum(step_s) / max(len(step_s), 1), 3),
        "next_s": {"median": statistics.median(step_s), "min": min(step_s), "max": max(step_s)} if step_s else None,
        "resume_s": [round(v, 3) for v in resume_s],
        "checkpoint_s": [round(v, 3) for v in checkpoint_s],
        "checkpoint_bytes": _bytes(ckpt),
        "total_fold_s": round(sum(step_s), 1),
        "final_verify_s": round(verify_s, 1),
        "verify_errors": [str(e) for e in errors],
        "z_final": [hex(v) for v in ivc.z_i],
    }
    with open(out, "a") as f:
        f.write(json.dumps(result) + "\n")
    return ivc, result


def main(argv=None) -> int:
    _, result = run(parser().parse_args(argv))
    print(json.dumps(result), flush=True)
    return 0 if not result["verify_errors"] else 1


if __name__ == "__main__":
    sys.exit(main())
