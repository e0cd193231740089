#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`sirius_tpu_torch`) on one GPU.

    python3 chip_smoke.py

1. Prints the card, its power limit and the torch version; builds the CUDA
   kernels from `sirius_tpu_torch/csrc/` (nvcc, sm_90a).
2. Keys: the bn256 2^20 key (b"bench-primary") and the grumpkin 2^17 key
   (b"bench-support"), derived on the device.
3. Holds every kernel against its plain torch twin on the card, on the same
   inputs: B1 madd bit-exact on 2^16 pairs per curve and at the cross-term
   step shape; best_msm's stages (B2 accumulate bit-exact, every B3 reduce
   level and the B3 combine in affine form) at the support W-commit shape,
   with kernel and twin timed there; best_msm at 2^12 against the
   big-integer reference; msm_many (B1 path) against best_msm (B2/B3 path)
   at the cross-term shape (5 x 2^14).
4. Commits 2^20 bn256 scalars (drawn as bench.py draws them): reference
   check on a 64-point prefix, every stage against its twin at 2^20, the
   result against best_msm's, then the points/s of one warm MSM.
5. Drives the Cyclefold support-fold chain: 3 Sangria folds of the EC
   co-processor circuit at k = 14 on the grumpkin key; verify must replay
   the prover's accumulator, is_sat must be clean and must catch a flipped
   witness cell; every kernel must have launched on this path.  Then one
   more fold runs under torch.profiler: its device events and the device's
   busy share of its wall time.

Ends with a JSON line of kernel results, the nvidia-smi line, and the
device JSON line.  Fails (non-zero exit, no result) without CUDA or on any
failed check.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

from sirius_tpu_torch.curves.hash_to_curve import hash_bytes_to_point
from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN, Points
from sirius_tpu_torch.ivc.support_fold import SupportFoldChain, random_input, support_structure
from sirius_tpu_torch.nifs.sangria import RelaxedPlonkTrace, RelaxedPlonkWitness
from sirius_tpu_torch.ops import _build, madd as madd_mod, msm_kernels as mk
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.ops.msm import FAN_IN, MANY_GROUPS, MANY_WINDOW_BITS, best_msm, bucket_plan, msm_many
from sirius_tpu_torch.ops.msm import split_segments
from sirius_tpu_torch.util.interop import limbs_to_words
from sirius_tpu_torch.util.testing import reference_msm

DEVICE = "cuda:0"
SEED = 20261016
FOLDS = 3
B1_PAIRS = 1 << 16
MSM_CHECK_LOG = 12
PRIMARY_LOG = 20
SUPPORT_KEY_LOG = 17
CROSS_TERMS = 5  # gate degree of the support circuit
CROSS_N = 1 << 14  # cross-term length (rows)
W_COMMIT_N = 7 << 14  # support W commit length (7 advice columns x 2^14 rows)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def gpu_ms(fn, reps: int = 3) -> float:
    """Mean device milliseconds per call (CUDA events, after one warm call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def word_err(a, b) -> float:
    """Largest absolute difference between two batches of word tensors
    (bit-exact: 0)."""
    return float(max(int((x - y).abs().max()) if x.numel() else 0 for x, y in zip(a, b)))


def point_err(curve, P, Q) -> float:
    """0 when the Jacobian batches P and Q hold the same points (affine
    equality, on the device): the identity flags must agree, and x1 z2^2,
    y1 z2^3 must equal x2 z1^2, y2 z1^3; otherwise the largest word
    difference of those products (at least 1)."""
    f = curve.fb
    z1s, z2s = f.square(P.z), f.square(Q.z)
    lhs = torch.stack([f.mul(P.x, z2s), f.mul(P.y, f.mul(z2s, Q.z))])
    rhs = torch.stack([f.mul(Q.x, z1s), f.mul(Q.y, f.mul(z1s, P.z))])
    flags = bool((f.is_zero(P.z) != f.is_zero(Q.z)).any())
    return max(word_err([lhs], [rhs]), float(flags))


def msm_stages(curve, S, pts, timed: bool = False):
    """best_msm's stages at the shapes it gives them: B2 accumulate, every
    B3 reduce level, B3 combine.  Each kernel is held against its plain twin
    on the same inputs, and the kernel's output feeds the next stage.
    Returns (the (1, 8) Jacobian result, {kernel: (max_abs_err, ms,
    plain_ms)}); times only when `timed` (the reduce time is its first
    level's)."""
    plan = bucket_plan(S)
    out = {}
    acc = (curve, plan.entries, plan.chunk_start, plan.chunk_len, pts.x.contiguous(), pts.y.contiguous())
    parts = mk.msm_accumulate(*acc)
    err = word_err(parts, mk.msm_accumulate_plain(*acc))
    check(err == 0, f"B2 msm_accumulate is not bit-exact against its twin at {S.shape[0]} points")
    out["msm_accumulate"] = [err, gpu_ms(lambda: mk.msm_accumulate(*acc)) if timed else None,
                             gpu_ms(lambda: mk.msm_accumulate_plain(*acc), reps=1) if timed else None]

    seg_off, level, red_err = plan.seg_off, 0, 0.0
    while True:
        deep = int((seg_off[1:] - seg_off[:-1]).max()) > FAN_IN
        sub_off, nxt = split_segments(seg_off, FAN_IN) if deep else (seg_off, None)
        red = mk.msm_reduce(curve, sub_off, parts)
        err = point_err(curve, red, mk.msm_reduce_plain(curve, sub_off, parts))
        check(err == 0, f"B3 msm_reduce level {level} disagrees with its twin at {S.shape[0]} points")
        red_err = max(red_err, err)
        if level == 0:
            args = (curve, sub_off, parts)
            out["msm_reduce"] = [None, gpu_ms(lambda: mk.msm_reduce(*args)) if timed else None,
                                 gpu_ms(lambda: mk.msm_reduce_plain(*args), reps=1) if timed else None]
        parts, level = red, level + 1
        if nxt is None:
            break
        seg_off = nxt
    out["msm_reduce"][0] = red_err

    shaped = Points(*(b.reshape(1, plan.W, plan.B, 8) for b in parts))
    res = mk.msm_combine(curve, shaped, plan.c)
    err = point_err(curve, res, mk.msm_combine_plain(curve, shaped, plan.c))
    check(err == 0, f"B3 msm_combine disagrees with its twin at {S.shape[0]} points")
    out["msm_combine"] = [err, gpu_ms(lambda: mk.msm_combine(curve, shaped, plan.c)) if timed else None,
                          gpu_ms(lambda: mk.msm_combine_plain(curve, shaped, plan.c), reps=1) if timed else None]
    return res, out, plan


def profile_fold(chain, inp) -> str:
    """One traced fold: device launches, device busy seconds (sum of the
    device-side events; one stream, so they do not overlap) and its share of
    the fold's wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        secs = chain.fold(inp)
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e6
    top = {}
    for e in dev:
        top[e.name] = top.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    lines = [f"profiled fold (profiler on): wall {wall:.4f} s ("
             + ", ".join(f"{k} {v:.4f} s" for k, v in secs.items())
             + f"), {len(dev)} device events, device busy {busy:.4f} s = {100 * busy / wall:.1f}% of wall"]
    for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:8]:
        lines.append(f"  {ms:9.3f} ms  {name[:90]}")
    return "\n".join(lines)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; the port's smoke run needs an NVIDIA GPU")

    dev = torch.device(DEVICE)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(0)} ({smi})"
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)

    def random_scalars(gen, shape):
        """Standard-form word tensor of 252-bit scalars (bench.py's draw)."""
        limbs = gen.integers(0, 1 << 16, size=(*shape, 16), dtype=np.uint32)
        limbs[..., 15] &= 0x0FFF
        return limbs, torch.from_numpy(limbs_to_words(limbs)).to(dev)

    def ints_of(limbs):
        return [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in limbs]

    # ---- keys -------------------------------------------------------------------
    t0 = time.perf_counter()
    ck1 = CommitmentKey.setup(BN256_G1, PRIMARY_LOG, b"bench-primary", use_cache=False, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ck2 = CommitmentKey.setup(GRUMPKIN, SUPPORT_KEY_LOG, b"bench-support", use_cache=False, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"keys: bn256 2^{PRIMARY_LOG} {t1 - t0:.2f} s, grumpkin 2^{SUPPORT_KEY_LOG} {t2 - t1:.2f} s  [{card}]")
    # spot-check the device hash-to-curve against the host map
    for ck, curve in ((ck1, BN256_G1), (ck2, GRUMPKIN)):
        stream = hashlib.shake_256(ck.label).digest(64 * 4)
        want = [hash_bytes_to_point(curve.spec, stream[64 * i : 64 * (i + 1)]) for i in range(4)]
        check(curve.decode(Points(*(c[:4] for c in ck.points))) == want, f"{curve} key prefix vs host map")

    kernels = {}

    def record(name, source, replaces, err, ms, plain_ms):
        kernels[name] = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                         "max_abs_err": err, "ms": round(ms, 4), "plain_ms": round(plain_ms, 4)}

    # ---- B1: madd, bit-exact on 2^16 pairs per curve ------------------------------------
    for ck, curve in ((ck1, BN256_G1), (ck2, GRUMPKIN)):
        n = B1_PAIRS
        K = ck.points
        P = curve.dbl(Points(*(c[n : 2 * n] for c in K)))  # Jacobian, z != 1
        P = Points(*(c.clone() for c in P))
        ident = curve.identity((64,), dev)
        for c, i in zip(P, ident):
            c[:64] = i  # identity rows: the result must be Q
        qx, qy = K.x[:n].contiguous(), K.y[:n].contiguous()
        err = word_err(madd_mod.madd_batch(curve, P, qx, qy), madd_mod.madd_plain(curve, P, qx, qy))
        check(err == 0, f"B1 madd on {curve} is not bit-exact (max err {err})")
        log(f"B1 madd {curve.spec.name} {n} pairs: bit-exact")

    # B1 at the support cross-term step shape: one lane per (term, window, group)
    lanes = CROSS_TERMS * (256 // MANY_WINDOW_BITS) * MANY_GROUPS
    K = ck2.points
    P = GRUMPKIN.dbl(Points(*(c[-lanes:] for c in K)))
    qx, qy = K.x[:lanes].contiguous(), K.y[:lanes].contiguous()
    err = word_err(madd_mod.madd_batch(GRUMPKIN, P, qx, qy), madd_mod.madd_plain(GRUMPKIN, P, qx, qy))
    check(err == 0, "B1 madd at the step shape is not bit-exact")
    ms = gpu_ms(lambda: madd_mod.madd_batch(GRUMPKIN, P, qx, qy), reps=20)
    plain = gpu_ms(lambda: madd_mod.madd_plain(GRUMPKIN, P, qx, qy), reps=3)
    record("madd", "sirius_tpu_torch/csrc/madd.cu", "sirius_tpu/ops/pallas_madd.py:136", err, ms, plain)
    log(f"B1 madd {lanes} lanes: bit-exact; kernel {ms:.4f} ms, plain {plain:.4f} ms  [{card}]")

    # ---- B2 + B3 at the support W-commit shape (7 x 2^14 grumpkin scalars) ----------------
    _, Sw = random_scalars(rng, (W_COMMIT_N,))
    pw = Points(*(c[:W_COMMIT_N] for c in ck2.points))
    res, stage, plan = msm_stages(GRUMPKIN, Sw, pw, timed=True)
    check(GRUMPKIN.decode(res)[0] == best_msm(GRUMPKIN, Sw, pw), "W-commit stages disagree with best_msm")
    for name, (err, ms, plain) in stage.items():
        record(name, "sirius_tpu_torch/csrc/msm.cu",
               "sirius_tpu/ops/pallas_msm.py:50" if name == "msm_accumulate" else "sirius_tpu/ops/pallas_msm.py:173",
               err, ms, plain)
    log(f"B2/B3 at {W_COMMIT_N} grumpkin points (c={plan.c}, W={plan.W}, B={plan.B}): every stage agrees "
        "with its twin; " + ", ".join(f"{k} {v[1]:.4f} ms (plain {v[2]:.4f} ms)" for k, v in stage.items())
        + f"  [{card}]")

    # best_msm at 2^12 against the big-integer reference
    n = 1 << MSM_CHECK_LOG
    limbs, S = random_scalars(rng, (n,))
    pts = Points(*(c[:n] for c in ck1.points))
    res, _, _ = msm_stages(BN256_G1, S, pts)
    want = reference_msm(ints_of(limbs), BN256_G1.decode(pts))
    check(best_msm(BN256_G1, S, pts) == want, "best_msm 2^12 disagrees with the reference MSM")
    check(BN256_G1.decode(res)[0] == want, "B2/B3 stages at 2^12 disagree with the reference MSM")
    log("B2/B3 best_msm 2^12 bn256: every stage agrees with its twin; result equals the reference MSM")

    # msm_many (B1 path) against best_msm (B2/B3 path) at the cross-term shape
    _, Sb = random_scalars(rng, (CROSS_TERMS, CROSS_N))
    pts2 = Points(*(c[:CROSS_N] for c in ck2.points))
    many = msm_many(GRUMPKIN, Sb, pts2)
    check(many == [best_msm(GRUMPKIN, Sb[i], pts2) for i in range(CROSS_TERMS)],
          "msm_many (B1 path) disagrees with best_msm (B2/B3 path)")
    log(f"msm_many {CROSS_TERMS} x 2^14 grumpkin: agrees with best_msm")

    # ---- 2^20 bn256 commit ---------------------------------------------------------------
    n = 1 << PRIMARY_LOG
    limbs, S = random_scalars(np.random.default_rng(42), (n,))
    mpre = 64
    prefix = Points(*(c[:mpre] for c in ck1.points))
    want = reference_msm(ints_of(limbs[:mpre]), BN256_G1.decode(prefix))
    check(best_msm(BN256_G1, S[:mpre], prefix) == want, "2^20 commit: reference prefix check")
    got = best_msm(BN256_G1, S, ck1.points)
    res, _, plan = msm_stages(BN256_G1, S, ck1.points)
    check(BN256_G1.decode(res)[0] == got, "2^20 commit: best_msm disagrees with the twin-checked stages")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best_msm(BN256_G1, S, ck1.points)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"2^20 bn256 MSM (c={plan.c}): prefix equals the reference, every stage agrees with its twin; "
        f"warm {dt:.4f} s = {n / dt:.0f} pts/s  [{card}]")

    # ---- the support-fold chain (main path; launch counts from here) --------------------------
    S_sup = support_structure()
    counters = (madd_mod.madd_batch, mk.msm_accumulate, mk.msm_reduce, mk.msm_combine)
    for fn in counters:
        fn.launches = 0
    chain = SupportFoldChain(ck2, S_sup)
    totals = {"witness": 0.0, "sps": 0.0, "prove": 0.0}
    for i in range(FOLDS):
        secs = chain.fold(random_input(rng))
        for k, v in secs.items():
            totals[k] += v
        log(f"fold {i}: " + ", ".join(f"{k} {v:.4f} s" for k, v in secs.items()) + f"  [{card}]")
    t0 = time.perf_counter()
    check(chain.verify() == chain.acc.U, "verify does not replay the prover's accumulator")
    t1 = time.perf_counter()
    errors = chain.is_sat()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    check(errors == [], f"is_sat reported {errors}")
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"support chain {FOLDS} folds k=14: witness {totals['witness']:.4f} s, sps {totals['sps']:.4f} s, "
        f"prove {totals['prove']:.4f} s, verify {t1 - t0:.4f} s, is_sat {t2 - t1:.4f} s, "
        f"{(totals['witness'] + totals['sps'] + totals['prove']) / FOLDS:.4f} s/fold  [{card}]")
    log(f"launch counts on the chain: {launches}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} never launched on the main path")

    # corruption probe: one flipped witness cell must be caught
    W0 = chain.acc.W.W[0].clone()
    W0[5, 0] ^= 1
    bad = RelaxedPlonkTrace(chain.acc.U, RelaxedPlonkWitness([W0, *chain.acc.W.W[1:]], chain.acc.W.E))
    bad_errors = chain.is_sat(bad)
    check(len(bad_errors) > 0, "is_sat missed a corrupted witness cell")
    log(f"corruption probe: {len(bad_errors)} error(s): {bad_errors[0]}")

    log(profile_fold(chain, random_input(rng)) + f"  [{card}]")
    check(chain.is_sat() == [], "is_sat after the profiled fold")

    for key, fn in zip(("madd", "msm_accumulate", "msm_reduce", "msm_combine"), counters):
        kernels[key]["launches"] = launches[fn.__name__]
    print(json.dumps({"kernels": list(kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
