"""The benchmark's data-driven core: cells, configurations, traffic mixes and
metric readers found by name, the program's set-up, and the measured window.

A cell of `BENCHMARK.json` names a configuration (`configs/<config>.json`)
and a traffic mix (`traffic/<traffic>.json`).  Every metric, end-to-end or
per-layer, is read by `metrics/<name>.py`, whose `read(run)` returns a
number or None (nothing to read in this run: the metric is left out).

The program under test is `sirius_tpu_torch`, imported only inside the
functions here that drive it, after `configure_environment` has fixed its
key cache inside the checkout.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / ".cache"
KEY_CACHE = CACHE_DIR / "keys"
PROGRAM = "sirius_tpu_torch"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sirius_tpu")


def configure_environment() -> None:
    """Fix every cache the program or torch may write at a path inside the
    checkout, before either is imported, and keep the program's spans off
    and their per-span file unset (the traced run turns spans on itself)."""
    os.environ["SIRIUS_TPU_CACHE"] = str(KEY_CACHE)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.pop("SIRIUS_TPU_PROFILE", None)
    os.environ.pop("SIRIUS_TPU_PROFILE_JSON", None)


# -- the catalog: BENCHMARK.json, configurations, mixes, readers ------------------------


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    with open(BENCH_DIR / "configs" / f"{name}.json") as f:
        return json.load(f)


def load_traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def load_reader(name: str) -> Callable:
    """`read` of `metrics/<name>.py` (a metric's name may hold dots, so the
    file is loaded by path, not imported by name)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of_cell(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end metrics untraced,
    its per-layer metrics traced (a metric without `workloads` belongs to
    every cell that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


def z0_of(cfg: dict, seed: int, modulus: int) -> list[int]:
    """The chain's z_0: `arity` field elements drawn uniformly from the seed,
    below 2^`z0_bits` where the configuration's step takes only such inputs
    (every seed gives the same sizes, and so the same work)."""
    rng = np.random.default_rng(seed)
    arity = cfg["step_circuit"]["kwargs"].get("arity", 1)
    bits = cfg.get("z0_bits", 256)
    return [int.from_bytes(rng.bytes(32), "little") % (1 << bits) % modulus for _ in range(arity)]


def step_circuit(cfg: dict, package: str):
    """The configuration's step circuit, built from `package` (the program,
    or the reference copy): `module` and `class` under the package, keyword
    arguments with "@name" resolved in the package's `fields.constants`."""
    sc = cfg["step_circuit"]
    consts = importlib.import_module(f"{package}.fields.constants")
    kwargs = {k: getattr(consts, v[1:]) if isinstance(v, str) and v.startswith("@") else v
              for k, v in sc["kwargs"].items()}
    return getattr(importlib.import_module(f"{package}.{sc['module']}"), sc["class"])(**kwargs)


# -- the program under test -------------------------------------------------------------


def synced(device) -> float:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def program_keys(cfg: dict, device):
    """The configuration's two commitment keys, by the program's own set-up,
    loaded from the checkout's key cache.  The first run in a checkout
    derives them from their labels into the cache, frees them, and loads
    them as every later run does, so that every run holds the same
    tensors."""
    import torch
    from sirius_tpu_torch.curves.jpoint import BN256_G1, GRUMPKIN
    from sirius_tpu_torch.ops.commitment import CommitmentKey

    curves = {"bn256": BN256_G1, "grumpkin": GRUMPKIN}
    specs = [(curves[key["curve"]], key["log2_size"], key["label"].encode())
             for key in (cfg["primary_key"], cfg["support_key"])]
    for spec in specs:
        if not os.path.exists(CommitmentKey.cache_file(*spec)):
            CommitmentKey.setup(*spec, device=device)
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    return tuple(CommitmentKey.setup(*spec, device=device) for spec in specs)


@dataclass
class Program:
    """The program's IVC for one cell, after set-up."""

    ivc: object
    z0: list[int]
    pp_s: float
    device: object
    ops_done: int = 0  # `next` calls made on the chain so far (set-up's included)


def public_params(cfg: dict, device, keys=None):
    """The program's keys and public parameters; (pp, seconds of the public
    parameters alone, closed by a device synchronize)."""
    from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldPublicParams

    if cfg["driver"] != "cyclefold":
        raise ValueError(f"driver {cfg['driver']!r}: the harness drives 'cyclefold'")
    ck1, ck2 = keys or program_keys(cfg, device)
    sc = step_circuit(cfg, PROGRAM)
    t0 = synced(device)
    pp = CyclefoldPublicParams(sc, cfg["k"], ck1, ck2)
    return pp, synced(device) - t0


def start_chain(pp, cfg: dict, traffic: dict, seed: int, device, pp_s: float = 0.0) -> Program:
    """`CyclefoldIVC.new` from the seed's z_0 and the mix's warm-up calls,
    `setup.next` steps; then a full garbage collection.  The program keeps device tensors in reference cycles that
    only the cyclic collector frees, so without it the window would start
    with as much garbage as the set-up's allocation history happened to
    leave (0.5-15.6 GiB)."""
    from sirius_tpu_torch.fields.constants import bn256_fr
    from sirius_tpu_torch.ivc.cyclefold_ivc import CyclefoldIVC

    z0 = z0_of(cfg, seed, bn256_fr.modulus)
    prog = Program(CyclefoldIVC(pp, z0), z0, pp_s, device)
    for _ in range(traffic["setup"]["next"]):
        prog.ivc.next()
        prog.ops_done += 1
    synced(device)
    gc.collect()
    return prog


def set_up(cfg: dict, traffic: dict, seed: int, device, keys=None) -> Program:
    """A cell's whole set-up: keys, public parameters (timed alone), new and
    the warm-up calls."""
    pp, pp_s = public_params(cfg, device, keys)
    return start_chain(pp, cfg, traffic, seed, device, pp_s)


def window(prog: Program, op: str, seconds: float, on_op: Optional[Callable[[float], None]] = None
           ) -> tuple[int, float]:
    """Call `op` on the chain back to back until the first call that ends
    at or after `seconds`; each call is closed by a device synchronize.
    Returns (calls, window seconds).  The judge checks the chain a window
    leaves, so the one operation is "next": a mix of another operation
    needs a judge of that operation's own answers first."""
    if op != "next":
        raise ValueError(f"op {op!r}: the harness drives and judges 'next'")
    calls = 0
    t0 = last = synced(prog.device)
    while True:
        prog.ivc.next()
        now = synced(prog.device)
        calls += 1
        prog.ops_done += 1
        if on_op is not None:
            on_op(now - last)
        last = now
        if now - t0 >= seconds:
            return calls, now - t0


# -- the program's state, by value ------------------------------------------------------


def _point(p) -> Optional[tuple[int, int]]:
    return None if p.is_identity else (int(p.x), int(p.y))


def _instance(u) -> dict:
    return {"W": [_point(c) for c in u.W_commitments], "instances": [[int(v) for v in row] for row in u.instances],
            "challenges": [int(v) for v in u.challenges]}


def snapshot(ivc) -> dict:
    """What the program's chain holds, as plain values and the witness word
    tensors: the ProtoGalaxy accumulator, the pending primary trace, the
    support chain's Sangria accumulator and public instances, the step and
    z_0 / z_i."""
    acc, sup = ivc.self_acc, ivc.support_acc
    return {
        "step": int(ivc.step),
        "z_0": [int(v) for v in ivc.z_0],
        "z_i": [int(v) for v in ivc.z_i],
        "pg_u": _instance(acc.trace.u),
        "pg_W": list(acc.trace.w.W),
        "pg_betas": [int(b) for b in acc.betas],
        "pg_e": int(acc.e),
        "pri_u": _instance(ivc.primary_trace.u),
        "pri_W": list(ivc.primary_trace.w.W),
        "sup_U": {"W": [_point(c) for c in sup.U.W_commitments],
                  "markers": [int(v) for v in sup.U.consistency_markers],
                  "challenges": [int(v) for v in sup.U.challenges],
                  "E": _point(sup.U.E_commitment), "u": int(sup.U.u),
                  "sc_hash": None if sup.U.sc_instances_hash_acc is None else int(sup.U.sc_instances_hash_acc)},
        "sup_W": list(sup.W.W),
        "sup_E": sup.W.E,
        "sup_pub": [[[int(v) for v in col] for col in insts] for insts in ivc.support_pub_instances],
    }


# -- a run's readings, for the metric readers -------------------------------------------


@dataclass
class Run:
    """What one run measured; `metrics/<name>.py` reads its metric from it."""

    op: str  # the mix's operation: "next"
    ops: int  # calls completed in the window (in a traced run: the traced calls)
    window_s: float  # (in a traced run: the traced part)
    setup_s: float
    pp_s: float
    peak_by_call: list = field(default_factory=list)  # device bytes: the window's peak as each call ended
    spans: dict = field(default_factory=dict)  # host seconds per span name over the window (traced run)
    trace: Optional[object] = None  # trace.DeviceTrace of the window (traced run)

    def span_per_op(self, *names: str) -> Optional[float]:
        """Host seconds per call in the named spans; None where none ran."""
        found = [self.spans[n] for n in names if n in self.spans]
        return sum(found) / self.ops if found and self.ops else None


def modules_loaded(names=FORBIDDEN_MODULES) -> list[str]:
    """The forbidden top-level modules this process holds, by whole name."""
    return sorted({m.split(".")[0] for m, mod in sys.modules.items() if mod is not None} & set(names))
