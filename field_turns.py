#!/usr/bin/env python3
"""The plain-torch field product of two checkouts of the port, timed in turns on one GPU.

    python3 field_turns.py OLD_DIR NEW_DIR
    python3 field_turns.py --turn DIR      (one turn alone: DIR's numbers)

Each turn is a fresh Python process that imports `sirius_tpu_torch` from
one checkout and measures, on inputs made from a fixed seed:
- `FR.mul` (`fields/jfield.Field.mul`, bn256 Fr, (n, 8) Montgomery words)
  at n = 2^10, 2^14, 2^17 and 2^20: milliseconds per call from CUDA events
  around 20 back-to-back calls after a warm one (at small n the calls are
  launch-bound, so this is the host's pace), and the device memory one call
  at 2^20 allocates above what was allocated before it;
- the NTT at 2^20 (forward and inverse, mean of 20 calls);
- `CyclefoldIVC` on `TrivialStepCircuit(1)` at k = 17 on mock commitment
  keys on the card (`util/testing.MockCommitmentKey`: a commitment is a sum,
  so the field ops carry the step): seconds of the public parameters, `new`
  and two `next`s, each closed by a synchronize, with the peak device
  memory of the second `next`.
The turns run OLD, NEW, NEW, OLD; each prints one JSON line, and the script
prints the card (name, power limit) and a JSON summary last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SEED = 20261018
SIZES = (10, 14, 17, 20)


def turn() -> None:
    """The child: measure the checkout on sys.path[0]."""
    import numpy as np
    import torch

    from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
    from sirius_tpu_torch.fields.jfield import FR
    from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldIVC, CyclefoldPublicParams
    from sirius_tpu_torch.ivc.step_circuit import TrivialStepCircuit
    from sirius_tpu_torch.ops.ntt import NTT
    from sirius_tpu_torch.util.testing import MockCommitmentKey

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(SEED)

    def elements(n):  # canonical Montgomery words below 2^252 (< p)
        w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.int64)
        w[:, 7] &= 0x0FFFFFFF
        return torch.from_numpy(w).to(dev)

    def event_ms(fn, reps=20):
        fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / reps

    def synced():
        torch.cuda.synchronize()
        return time.perf_counter()

    out = {}
    for lg in SIZES:
        a, b = elements(1 << lg), elements(1 << lg)
        out[f"mul_2^{lg}_ms"] = event_ms(lambda: FR.mul(a, b))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    FR.mul(a, b)
    torch.cuda.synchronize()
    out["mul_2^20_peak_bytes"] = torch.cuda.max_memory_allocated() - base
    ntt = NTT(FR, 20, dev)
    x = elements(1 << 20)
    out["fft_2^20_ms"] = event_ms(lambda: ntt.fft(x))
    out["ifft_2^20_ms"] = event_ms(lambda: ntt.ifft(x))
    t0 = synced()
    pp = CyclefoldPublicParams(TrivialStepCircuit(1), 17, MockCommitmentKey(BN256_G1, dev),
                               MockCommitmentKey(GRUMPKIN, dev))
    t1 = synced()
    ivc = CyclefoldIVC(pp, [0x42])
    t2 = synced()
    ivc.next()
    t3 = synced()
    torch.cuda.reset_peak_memory_stats()
    ivc.next()
    t4 = synced()
    out["next_2_peak_bytes"] = torch.cuda.max_memory_allocated()
    out.update(pp_s=t1 - t0, new_s=t2 - t1, next_1_s=t3 - t2, next_2_s=t4 - t3)
    assert ivc.verify() == [], "the mock-key Cyclefold run did not verify"
    print(json.dumps(out))


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        sys.path.insert(0, str(Path(sys.argv[2]).resolve()))
        turn()
        return 0
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    dirs = {"old": str(Path(sys.argv[1]).resolve()), "new": str(Path(sys.argv[2]).resolve())}
    runs: dict[str, list[dict]] = {"old": [], "new": []}
    for key in ("old", "new", "new", "old"):
        proc = subprocess.run([sys.executable, __file__, "--turn", dirs[key]], cwd=dirs[key],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"field_turns: the {key} turn failed:\n{proc.stderr[-3000:]}")
        runs[key].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(key, runs[key][-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"card": smi, **runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
