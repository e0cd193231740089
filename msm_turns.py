#!/usr/bin/env python3
"""The MSM kernels (B1-B3), S1, S2, S3 and the NTT's kernels of two checkouts of the port, timed in turns on one GPU.

    python3 msm_turns.py OLD_DIR NEW_DIR
    python3 msm_turns.py --turn DIR      (one turn alone: DIR's numbers)

Each turn is a fresh Python process that imports `sirius_tpu_torch` from
one checkout (building its kernels there at first use) and times, with CUDA
events (mean of 10 calls after one warm call unless noted), on inputs made
from a fixed seed:
- `msm_combine` at best_msm's shape (1, W = 27, B = 512, c = 10) and at
  msm_many's (t = 5, W = 64, B = 15, c = 4), on Jacobian bucket sums drawn
  from a 2^10 grumpkin key (the time does not depend on the values);
- `msm_reduce` on the first reduce level of the support W commit (114,688
  grumpkin scalars, c = 10, as `bench.py` draws them): the real segment
  offsets, over Jacobian partials from the same key;
- B2 `msm_accumulate` and `bucket_plan` (3 calls; its host syncs included)
  at the IVC path's two W-commit shapes: the support commit (114,688
  grumpkin scalars) and the primary commit (917,504 bn256 scalars), both
  c = 10, over a 2^14 key tiled to the commit's length (the memory
  footprint of the real key; repeated values cost the same adds);
- msm_many's bucket stage at the support cross-term shape (t = 5, 2^14
  grumpkin points, 4-bit windows, 256 groups): one `madd_buckets` launch
  where the checkout has it, else the per-step loop of B1 launches with the
  one-hot select and write-back; and the whole `msm_many` call (3 calls);
- B1's batched `madd_batch` at 81,920 grumpkin lanes (an msm_many step's
  5 x 64 x 256; Jacobian P doubled from a 2^10 key, affine Q of the 2^14
  key at random indices): the device time per launch from a CUDA graph of
  20 launches replayed 5 times (`graph_ms`: the kernel takes about its
  wrapper's host time, so back-to-back events read the host) and back to
  back (mean of 20 calls);
- S1 `msm_reduce_rolled` on the reduce inputs above, and `msm_reduce` and
  S1 on the first reduce level of the primary W commit (917,504 bn256
  scalars, c = 10, over Jacobian partials from a 2^10 bn256 key), S1 also
  on its unsplit bucket segments: each also as its kernel's own device
  time per call (`*_kernel`: CUDA events around each launch, `kernel_ms`;
  the wrappers read the segments on the host each call, which the events
  around the whole call include);
- S2, the field-rate probe: `mul_chain` at K = 8 over 2^17 bn256 Fr
  elements on the unrolled, the carry-chain and (where the checkout has
  it) the wide product, from a CUDA graph of 50 launches and back to back
  (mean of 50 calls), and the latency probe: one
  element, K = 1024 dependent products, on each of the checkout's products
  (mean of 5 calls; microseconds per product);
- the NTT at 2^20 on random bn256 Fr elements (mean of 20 calls): B4
  `col_ntt` at the first pass's shape (size 1024 over R = 1024 columns),
  its epilogue variant with the mid twiddle and transpose (where the
  checkout has it), the field product `mul_rows` at K = 1 over 2^20 rows
  (the coset powers: b of 3 rows; rep = 1, b the mid twiddle; rep = 4, b
  its first 2^18 rows), and the whole forward and inverse transforms (mid
  twiddles built first);
- S3 `raw_u32`, mul and add, on 2^22 words (int32 where the checkout's
  wrapper takes them, int64 before) at 64 reps, the device time per launch
  from a CUDA graph of 50 launches replayed 5 times (`graph_ms`) and back
  to back (mean of 50 calls), and at 4096 (mean of 10).
`gpu_ms`, `graph_ms` and `kernel_ms` are also the timers of
`chip_smoke.py`, which imports them from here.
The turns run OLD, NEW, NEW, OLD; each prints one JSON line, and the script
prints the card (name, power limit) and a JSON summary last.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

SEED = 20261016
W_COMMIT_N = 7 << 14  # the support W commit: 7 advice columns x 2^14 rows
PRIMARY_N = 7 << 17  # the primary W commit: 7 advice columns x 2^17 rows
CROSS = (5, 1 << 14)  # msm_many at the support cross terms: (t, n)
SLEEP_CYCLES = 1 << 20  # ~0.5 ms of device clock ahead of each span of kernel_ms
SHAPES = {"combine_1x27x512": (1, 27, 512, 10), "combine_5x64x15": (5, 64, 15, 4)}


def old_bucket_stage(curve, scalars, px, py, G, c):
    """msm_many's bucket stage before `madd_buckets`: one B1 launch per step,
    the bucket each lane's digit selects taken by a one-hot multiply-and-sum
    over the table and written back with torch.where."""
    import torch

    from sirius_tpu_torch.ops.madd import madd_batch
    from sirius_tpu_torch.ops.msm import _extract_digits

    t, n = scalars.shape[:2]
    B, g = (1 << c) - 1, n // G
    digits = _extract_digits(scalars, c)
    W = digits.shape[1]
    dg = digits.reshape(t, W, G, g)
    pxg, pyg = px.reshape(G, g, 8), py.reshape(G, g, 8)
    vs = torch.arange(1, B + 1, device=scalars.device)
    table = curve.identity((t, W, G, B), scalars.device)
    lanes = t * W * G
    for step in range(g):
        oh = (dg[..., step, None] == vs).unsqueeze(-1)
        cur = type(table)(*((tc * oh).sum(3).reshape(lanes, 8) for tc in table))
        qx = pxg[:, step].expand(t, W, G, 8).reshape(lanes, 8)
        qy = pyg[:, step].expand(t, W, G, 8).reshape(lanes, 8)
        new = madd_batch(curve, cur, qx, qy)
        table = type(table)(*(torch.where(oh, nc.reshape(t, W, G, 1, 8), tc) for tc, nc in zip(table, new)))
    return table


def gpu_ms(fn, reps: int = 3) -> float:
    """Mean device milliseconds per call (CUDA events, after one warm call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, launches: int = 200, reps: int = 5) -> tuple[float, int]:
    """(device milliseconds per call of fn without the host between calls,
    the kernel launches its replays made that no wrapper counted): a CUDA
    graph captures `launches` calls (a wrapper counts each at capture) and
    is replayed once warm and `reps` times under CUDA events, after one warm
    call on a side stream.  A wrapper that launches once a call has made
    launches x reps more launches than its count says."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * launches), launches * reps


def kernel_ms(fn, symbol: str, reps: int = 10) -> float:
    """Device milliseconds per call of fn in the launches it makes through
    the kernel library's entry `symbol`: CUDA events recorded on the stream
    just before and after each launch (mean over `reps` calls, after one
    warm call), so the host reads a wrapper makes between its launches fall
    outside.  A device sleep queued ahead of each start event keeps the
    stream busy while the host enqueues the event and the launch, so the
    span holds the kernel and not the host's launch latency."""
    import torch

    from sirius_tpu_torch.ops import _build

    lib = _build.library()
    launch = getattr(lib, symbol)
    spans = []

    def timed(*args):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        err = launch(*args)
        end.record()
        spans.append((start, end))
        return err

    fn()
    setattr(lib, symbol, timed)
    try:
        for _ in range(reps):
            fn()
    finally:
        setattr(lib, symbol, launch)
    torch.cuda.synchronize()
    if not spans:
        raise SystemExit(f"kernel_ms: fn made no launch through {symbol}")
    return sum(start.elapsed_time(end) for start, end in spans) / reps


def msm_turn(out, rng, dev, ck, jacobian, scalars, gpu_ms) -> None:
    """B1-B3 and S1 of the checkout on sys.path[0], into `out`."""
    import torch

    from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN, Points
    from sirius_tpu_torch.ops import madd as madd_mod
    from sirius_tpu_torch.ops import msm_kernels as mk
    from sirius_tpu_torch.ops.commitment import CommitmentKey
    from sirius_tpu_torch.ops.msm import FAN_IN, MANY_GROUPS, MANY_WINDOW_BITS, bucket_plan, msm_many
    from sirius_tpu_torch.ops.msm import split_segments

    for name, (t, W, B, c) in SHAPES.items():
        bk = Points(*(a.reshape(t, W, B, 8) for a in jacobian(t * W * B)))
        out[name] = gpu_ms(lambda: mk.msm_combine(GRUMPKIN, bk, c))
    plan = bucket_plan(scalars((W_COMMIT_N,)))
    sub_off, _ = split_segments(plan.seg_off, FAN_IN)
    parts = jacobian(int(plan.seg_off[-1]))
    out["reduce_level0"] = gpu_ms(lambda: mk.msm_reduce(GRUMPKIN, sub_off, parts))

    for label, curve, n in (("support", GRUMPKIN, W_COMMIT_N), ("primary", BN256_G1, PRIMARY_N)):
        key = CommitmentKey.setup(curve, 14, b"msm-turns", use_cache=False, device=dev)
        reps = -(-n // len(key))
        px, py = (c.repeat(reps, 1)[:n].contiguous() for c in key.points[:2])
        S = scalars((n,))
        plan = bucket_plan(S)
        args = (curve, plan.entries, plan.chunk_start, plan.chunk_len, px, py)
        out[f"accumulate_{label}"] = gpu_ms(lambda: mk.msm_accumulate(*args))
        out[f"bucket_plan_{label}"] = gpu_ms(lambda: bucket_plan(S), reps=3)
        out[f"live_digits_{label}"] = int(plan.entries.shape[0])
        out[f"chunks_{label}"] = int(plan.chunk_start.shape[0])

    t, n = CROSS
    key = CommitmentKey.setup(GRUMPKIN, 14, b"msm-turns", use_cache=False, device=dev)
    S = scalars((t, n))
    px, py = key.points.x[:n].contiguous(), key.points.y[:n].contiguous()
    G, c = MANY_GROUPS, MANY_WINDOW_BITS
    if hasattr(madd_mod, "madd_buckets"):
        stage = lambda: madd_mod.madd_buckets(GRUMPKIN, S, px, py, G, c)  # noqa: E731
    else:
        stage = lambda: old_bucket_stage(GRUMPKIN, S, px, py, G, c)  # noqa: E731
    out["many_bucket_stage"] = gpu_ms(stage, reps=3)
    out["msm_many"] = gpu_ms(lambda: msm_many(GRUMPKIN, S, key.points), reps=3)
    lanes = t * 64 * G  # an msm_many step: 5 terms x 64 windows x 256 groups
    idx = torch.from_numpy(rng.integers(0, len(key), size=lanes)).to(dev)
    P, qx, qy = jacobian(lanes), key.points.x[idx].contiguous(), key.points.y[idx].contiguous()
    out["madd_81920"] = graph_ms(lambda: madd_mod.madd_batch(GRUMPKIN, P, qx, qy), launches=20)[0]
    out["madd_81920_back_to_back"] = gpu_ms(lambda: madd_mod.madd_batch(GRUMPKIN, P, qx, qy), reps=20)

    out["reduce_rolled_level0"] = gpu_ms(lambda: mk.msm_reduce_rolled(GRUMPKIN, sub_off, parts))
    out["reduce_rolled_level0_kernel"] = kernel_ms(lambda: mk.msm_reduce_rolled(GRUMPKIN, sub_off, parts),
                                                   "sirius_msm_reduce_rolled")
    ckb = CommitmentKey.setup(BN256_G1, 10, b"msm-turns", use_cache=False, device=dev)
    ptsb = BN256_G1.dbl(Points(*(c.contiguous() for c in ckb.points)))
    plan = bucket_plan(scalars((PRIMARY_N,)))
    sub_off, _ = split_segments(plan.seg_off, FAN_IN)
    idx = torch.from_numpy(rng.integers(0, len(ckb), size=int(plan.seg_off[-1]))).to(dev)
    parts = Points(*(c[idx].contiguous() for c in ptsb))
    for name, fn in (("reduce_primary_level0", lambda: mk.msm_reduce(BN256_G1, sub_off, parts)),
                     ("reduce_rolled_primary_level0", lambda: mk.msm_reduce_rolled(BN256_G1, sub_off, parts)),
                     ("reduce_rolled_primary_unsplit", lambda: mk.msm_reduce_rolled(BN256_G1, plan.seg_off, parts))):
        out[name] = gpu_ms(fn)
        out[f"{name}_kernel"] = kernel_ms(fn, "sirius_msm_reduce" if name == "reduce_primary_level0"
                                          else "sirius_msm_reduce_rolled")


def turn() -> None:
    """The child: time the kernels of the checkout on sys.path[0]."""
    import numpy as np
    import torch

    from sirius_tpu_torch.curves.jpoint import GRUMPKIN, Points
    from sirius_tpu_torch.fields.jfield import FR
    from sirius_tpu_torch.ops.commitment import CommitmentKey
    from sirius_tpu_torch.ops.field_kernels import PRODUCTS, mul_rows
    from sirius_tpu_torch.ops import microbench
    from sirius_tpu_torch.ops.microbench import mul_chain
    from sirius_tpu_torch.ops.ntt import NTT
    from sirius_tpu_torch.ops.ntt_kernels import col_ntt
    from sirius_tpu_torch.util.interop import limbs_to_words

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(SEED)
    ck = CommitmentKey.setup(GRUMPKIN, 10, b"msm-turns", use_cache=False, device=dev)
    pts = GRUMPKIN.dbl(Points(*(c.contiguous() for c in ck.points)))

    def jacobian(n):
        idx = torch.from_numpy(rng.integers(0, len(ck), size=n)).to(dev)
        return Points(*(c[idx].contiguous() for c in pts))

    def scalars(shape):
        limbs = rng.integers(0, 1 << 16, size=(*shape, 16), dtype=np.uint32)
        limbs[..., 15] &= 0x0FFF
        return torch.from_numpy(limbs_to_words(limbs)).to(dev)

    out = {}
    msm_turn(out, rng, dev, ck, jacobian, scalars, lambda fn, reps=10: gpu_ms(fn, reps))

    def elements(n):  # canonical Montgomery words below 2^252 (< p)
        w = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.int64)
        w[:, 7] &= 0x0FFFFFFF
        return torch.from_numpy(w).to(dev)

    a2, b2, a1, b1 = elements(1 << 17), elements(1 << 17), elements(1), elements(1)
    for product in [p for p in ("unrolled", "cc", "wide") if p in PRODUCTS]:
        out[f"s2_k8_{product}"] = graph_ms(lambda: mul_chain(FR, a2, b2, 8, product=product), launches=50)[0]
        out[f"s2_k8_{product}_back_to_back"] = gpu_ms(lambda: mul_chain(FR, a2, b2, 8, product=product), reps=50)
    for product in PRODUCTS:
        out[f"latency_us_{product}"] = gpu_ms(lambda: mul_chain(FR, a1, b1, 1024, product=product), reps=5) / 1024 * 1e3
    ntt = NTT(FR, 20, dev)
    M = FR.random((1 << 20,), rng, dev).reshape(ntt.n1, ntt.n2, 8)
    T = ntt.mid_twiddle(False)
    ntt.mid_twiddle(True)
    a = M.reshape(-1, 8)
    out["col_ntt_1024"] = gpu_ms(lambda: col_ntt(FR, M, ntt.rev_n1, ntt.inner[False]), reps=20)
    if "mid" in inspect.signature(col_ntt).parameters:
        out["col_ntt_mid_1024"] = gpu_ms(lambda: col_ntt(FR, M, ntt.rev_n1, ntt.inner[False], T), reps=20)
    out["mul_rows_k1_2^20_coset"] = gpu_ms(lambda: mul_rows(FR, a, ntt.zeta_pows), reps=20)
    out["mul_rows_k1_2^20"] = gpu_ms(lambda: mul_rows(FR, a, T), reps=20)
    out["mul_rows_k1_2^20_rep4"] = gpu_ms(lambda: mul_rows(FR, a, T[: 1 << 18], rep=4), reps=20)
    out["fft_2^20"] = gpu_ms(lambda: ntt.fft(a), reps=20)
    out["ifft_2^20"] = gpu_ms(lambda: ntt.ifft(a), reps=20)
    words = torch.from_numpy(rng.integers(0, 1 << 32, size=1 << 22, dtype=np.int64)).to(dev)
    if getattr(microbench, "RAW_WORDS", torch.int64) == torch.int32:  # the checkout's S3 takes int32 words
        words = microbench.words_of(words)
    for op in ("mul", "add"):
        out[f"s3_{op}_64"] = graph_ms(lambda: microbench.raw_u32(words, op, 64), launches=50)[0]
        out[f"s3_{op}_64_back_to_back"] = gpu_ms(lambda: microbench.raw_u32(words, op, 64), reps=50)
        out[f"s3_{op}_4096"] = gpu_ms(lambda: microbench.raw_u32(words, op, 4096), reps=10)
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
