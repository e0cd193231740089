"""Run one cell of the port's benchmark once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `port_bench/` and
the program, `sirius_tpu_torch/`, on a machine with the CUDA cards the
cell asks for.  Set-up (imports, the kernel library, the keys, the public
parameters, `new` and the mix's warm-up calls) is timed as `setup_s`; the
window then calls the mix's operation back to back for `--seconds`; then
the plain reference judges what the window left (`judge.py`).  The last
lines of standard error give every compared number beside its limit; the
last line of standard output is the result as one JSON object.  With
`--trace 1` the window runs under the profiler with the program's spans on,
and the result holds the cell's per-layer metrics instead of its
end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness  # noqa: E402


def log(msg: str) -> None:
    print(f"[port_bench {time.perf_counter() - T_START:8.2f}s] {msg}", file=sys.stderr, flush=True)


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_block(chips: int, peak: int, trace=None) -> dict:
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips, "memory_peak_bytes": peak}
    if trace is not None:
        out["busy_s"], out["window_s"] = trace.busy_s, trace.window_s
    return out


def main(argv=None) -> int:
    args = parse(argv)
    harness.configure_environment()
    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    cfg, traffic = harness.load_config(cell["config"]), harness.load_traffic(cell["traffic"])
    wanted = harness.metrics_of_cell(bench, cell["name"], bool(args.trace))
    readers = {m["name"]: harness.load_reader(m["name"]) for m in wanted}

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"needs {cell['chips']} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)

    from sirius_tpu_torch.ops.commitment import CommitmentKey
    from sirius_tpu_torch.util.profiling import profiler

    from port_bench import trace as tracing

    prog = harness.set_up(cfg, traffic, args.seed, device)
    op = traffic["op"]
    setup_s = time.perf_counter() - T_START
    log(f"{cell['name']} seed {args.seed}: set-up {setup_s:.3f} s (pp {prog.pp_s:.3f} s)")

    torch.cuda.reset_peak_memory_stats(device)
    dts, peaks = [], []  # each call's seconds; the window's peak so far as each call ends
    tracer = tracing.Tracer(CommitmentKey, lambda: harness.synced(device), profiler) if args.trace else None

    def on_op(dt: float) -> None:
        dts.append(dt)
        peaks.append(torch.cuda.max_memory_allocated(device))
        if tracer is not None and tracer.on and sum(dts) >= traffic["trace_seconds"]:
            tracer.stop(len(dts), sum(dts))

    if tracer is not None:
        tracer.start()
    t0 = harness.synced(device)
    ops, window_s = harness.window(prog, op, args.seconds, on_op)
    if tracer is not None and tracer.on:
        tracer.stop(len(dts), sum(dts))
    peak_window = torch.cuda.max_memory_allocated(device)
    log(f"window: {ops} x {op} in {window_s:.4f} s, peak {peak_window / 2**30:.4f} GiB; each "
        + " ".join(f"{dt:.4f}" for dt in dts))

    if tracer is None:
        run = harness.Run(op=op, ops=ops, window_s=window_s, setup_s=setup_s, pp_s=prog.pp_s, peak_by_call=peaks)
    else:  # the per-layer metrics read the traced calls
        run = harness.Run(op=op, ops=tracer.calls, window_s=tracer.seconds, setup_s=setup_s, pp_s=prog.pp_s,
                          peak_by_call=peaks, spans=tracing.span_totals(profiler.roots))
        run.trace = tracer.read(t0)
        profiler.roots.clear()
        log(f"trace of the first {tracer.calls} calls: busy {run.trace.busy_s:.4f} s of {tracer.seconds:.4f} s, "
            f"{run.trace.launches} launches, {len(run.trace.commits)} commits")
        del tracer
    metrics = {}
    for m in wanted:
        value = readers[m["name"]](run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the reference runs after the window and the peak reading, on the
    # program's final chain state alone
    state = harness.snapshot(prog.ivc)
    z0, expected_step = prog.z0, 1 + prog.ops_done
    device_info = device_block(cell["chips"], peak_window, run.trace)
    del prog
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    from port_bench.judge import judge

    checks = judge(cfg, state, z0, expected_step, args.seed, device)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    correct = all(c.ok for c in checks)

    found = harness.modules_loaded()
    if found:
        log(f"forbidden modules loaded in this process: {', '.join(found)}")
        return 3
    result = {"correct": correct, "attempted": ops, "failed": 0, "metrics": metrics, "device": device_info}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops, "idle_gaps": run.trace.idle_by_span}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    for c in checks:
        print(f"check {c.name}: {c.value} (limit {c.limit}) {'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(f"correct: {correct}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
