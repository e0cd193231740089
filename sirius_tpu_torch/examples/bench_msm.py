"""The CLI's `bench-msm` mode: one warm 2^20 bn256 MSM in points/s, timed
the way `bench.py:74-107` times the JAX package's (scalars of 252 bits from
numpy's generator seeded 42, a check of a 64-point prefix against the
big-integer reference, one warm-up, one timed run), on the port's
`best_msm` (B2's bucket sort and accumulation, B3's reduce and combine).
2^10 points with `--cpu`, as `bench.py` sizes its CPU run.

    python -m sirius_tpu_torch.examples.bench_msm [--cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ._drive import Clock, timed


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="bench_msm")
    ap.add_argument("--cpu", action="store_true")
    return ap


def run(args, keys=None, device=None):
    """(None, timings: log_n, msm_s, points_per_s, device name); `keys[0]`,
    when given, is the bn256 key (at least 2^log_n points)."""
    from ..curves.jpoint import BN256_G1, Points
    from ..ops.commitment import CommitmentKey
    from ..ops.msm import best_msm
    from ..util.device import resolve
    from ..util.interop import limbs_to_words
    from ..util.testing import reference_msm

    device = resolve("cpu" if args.cpu else device)
    on_card = device.type == "cuda"
    log_n = 20 if on_card else 10
    ck = keys[0] if keys else CommitmentKey.setup(BN256_G1, 20 if on_card else 14, b"bench-primary", device=device)
    n = 1 << log_n
    limbs = np.random.default_rng(42).integers(0, 1 << 16, size=(n, 16), dtype=np.uint32)
    limbs[:, 15] &= 0x0FFF  # uniform over [0, 2^252) < r
    scalars = torch.from_numpy(limbs_to_words(limbs)).to(ck.device)
    points = Points(*(c[:n] for c in ck.points))

    m = 64
    prefix = Points(*(c[:m] for c in points))
    want = reference_msm([sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in limbs[:m]],
                         BN256_G1.decode(prefix))
    if best_msm(BN256_G1, scalars[:m], prefix) != want:
        raise RuntimeError("the MSM disagrees with the big-integer reference")
    clock = Clock(ck.device)
    best_msm(BN256_G1, scalars, points)  # warm-up
    _, dt = timed(clock, lambda: best_msm(BN256_G1, scalars, points))
    name = torch.cuda.get_device_name(ck.device) if on_card else "cpu"
    t = dict(log_n=log_n, msm_s=dt, points_per_s=n / dt, device=name)
    print(f"msm 2^{log_n} bn256 on {name}: {dt:.4f}s = {n / dt:.0f} points/s")
    print(json.dumps({"metric": f"commit_msm_points_per_sec_2^{log_n}", "value": round(n / dt, 1),
                      "unit": "points/s", "device": name}), flush=True)
    return None, t


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
