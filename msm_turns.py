#!/usr/bin/env python3
"""B3's kernels of two checkouts of the port, timed in turns on one GPU.

    python3 msm_turns.py OLD_DIR NEW_DIR

Each turn is a fresh Python process that imports `sirius_tpu_torch` from
one checkout (building its kernels there at first use) and times, with CUDA
events (mean of 10 calls after one warm call), on inputs made from a fixed
seed:
- `msm_combine` at best_msm's shape (1, W = 27, B = 512, c = 10) and at
  msm_many's (t = 5, W = 64, B = 15, c = 4), on Jacobian bucket sums drawn
  from a 2^10 grumpkin key (the time does not depend on the values);
- `msm_reduce` on the first reduce level of the support W commit (114,688
  grumpkin scalars, c = 10, as `bench.py` draws them): the real segment
  offsets, over Jacobian partials from the same key.
The turns run OLD, NEW, NEW, OLD; each prints one JSON line, and the script
prints the card (name, power limit) and a JSON summary last.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SEED = 20261016
W_COMMIT_N = 7 << 14
SHAPES = {"combine_1x27x512": (1, 27, 512, 10), "combine_5x64x15": (5, 64, 15, 4)}


def turn() -> None:
    """The child: time the kernels of the checkout on sys.path[0]."""
    import numpy as np
    import torch

    from sirius_tpu_torch.curves.jpoint import GRUMPKIN, Points
    from sirius_tpu_torch.ops import msm_kernels as mk
    from sirius_tpu_torch.ops.commitment import CommitmentKey
    from sirius_tpu_torch.ops.msm import FAN_IN, bucket_plan, split_segments
    from sirius_tpu_torch.util.interop import limbs_to_words

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(SEED)
    ck = CommitmentKey.setup(GRUMPKIN, 10, b"msm-turns", use_cache=False, device=dev)
    pts = GRUMPKIN.dbl(Points(*(c.contiguous() for c in ck.points)))

    def jacobian(n):
        idx = torch.from_numpy(rng.integers(0, len(ck), size=n)).to(dev)
        return Points(*(c[idx].contiguous() for c in pts))

    def gpu_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {}
    for name, (t, W, B, c) in SHAPES.items():
        bk = Points(*(a.reshape(t, W, B, 8) for a in jacobian(t * W * B)))
        out[name] = gpu_ms(lambda: mk.msm_combine(GRUMPKIN, bk, c))
    limbs = rng.integers(0, 1 << 16, size=(W_COMMIT_N, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x0FFF
    plan = bucket_plan(torch.from_numpy(limbs_to_words(limbs)).to(dev))
    sub_off, _ = split_segments(plan.seg_off, FAN_IN)
    parts = jacobian(int(plan.seg_off[-1]))
    out["reduce_level0"] = gpu_ms(lambda: mk.msm_reduce(GRUMPKIN, sub_off, parts))
    print(json.dumps(out))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        sys.path.insert(0, sys.argv[2])
        turn()
        return 0
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    dirs = {"old": str(Path(sys.argv[1]).resolve()), "new": str(Path(sys.argv[2]).resolve())}
    runs: dict[str, list[dict]] = {"old": [], "new": []}
    for key in ("old", "new", "new", "old"):
        proc = subprocess.run([sys.executable, __file__, "--turn", dirs[key]], cwd=dirs[key],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"msm_turns: the {key} turn failed:\n{proc.stderr[-3000:]}")
        runs[key].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(key, runs[key][-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"card": smi, **runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
