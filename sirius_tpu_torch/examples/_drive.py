"""What the examples share: a clock that waits for the device, the fold loop
and the verify step, each printing the JAX examples' lines."""

from __future__ import annotations

import time

import torch


class Clock:
    """Host seconds; on a CUDA device each reading first waits for the
    device's queued work, so a phase's time includes its kernels."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __call__(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()


def peak_reset(device) -> None:
    """Start a peak-device-memory reading (nothing on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int | None:
    """Peak device memory allocated since `peak_reset` (None on the CPU)."""
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else None


def span_totals() -> dict[str, float]:
    """Host seconds per `util/profiling` span name since the last call (the
    records are then drained); empty unless the profiler is on
    (SIRIUS_TPU_PROFILE=1, or the CLI's --profile-json)."""
    from ..util.profiling import profiler

    out = profiler.totals()
    profiler.drain()
    return out


def timed(clock: Clock, fn):
    """(fn(), seconds)."""
    t0 = clock()
    out = fn()
    return out, clock() - t0


def fold_steps(clock: Clock, step, n: int, line=lambda i, dt: f"ivc_next {i}: {dt:.2f}s") -> list[float]:
    """Run `step` n times, printing `line(i, seconds)` after each."""
    times = []
    for i in range(n):
        _, dt = timed(clock, step)
        times.append(dt)
        print(line(i, dt), flush=True)
    return times


def verify(clock: Clock, ivc, label: str = "ivc_verify") -> tuple[list, float]:
    """(errors, seconds) of `ivc.verify()`, printed as `<label>: <s>s -> OK`."""
    errors, dt = timed(clock, ivc.verify)
    print(f"{label}: {dt:.2f}s ->", "OK" if not errors else errors, flush=True)
    return errors, dt
