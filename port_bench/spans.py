"""Each kernel of a traced window put down to the program's span that
launched it, and the span readings the per-layer metrics read.

The program's profiler (`sirius_tpu_torch/util/profiling`) records each span
with an id, its parent's id, the step it belongs to, its thread, stamps on
the Unix-ns clock that torch.profiler's events carry, and counts.  A kernel
event of the traced window (the events `launches_per_step` counts: not
Memcpy* or Memset*) joins its launch record, the runtime (`cudaLaunchKernel`)
or driver (`cuLaunchKernel`) event with the same correlation id, and goes to
the innermost span open on the launching thread at the launch's timestamp,
or to OUTSIDE.  A kernel with no launch record is unmatched.  A span name's
count covers its descendants.

A reader of these metrics calls `install()` when it is loaded, which happens
in a traced run only, before set-up: that turns the program's spans on, so
the set-up spans are kept, and wraps `trace.device_events` and
`trace.summarize` to keep the profile and the traced window they are handed
(their results are unchanged).  The first reader to ask (`of(run)`) drains
the records, joins the profile's events and keeps the readings on the run.
Against a program whose profiler keeps no records `install()` does nothing
and every reading is None.
"""

from __future__ import annotations

import bisect
import sys
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Optional

from port_bench import trace
from port_bench.trace import OUTSIDE
TID_MASK = 0xFFFFFFFF  # a launch record's thread: the low 32 bits of the launching thread's pthread id
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")  # cudaLaunchKernel, cuLaunchKernel and their Ex forms


@dataclass
class Attribution:
    """The traced window's kernels by the span that launched them."""

    kernels: int = 0  # kernel events of the window
    in_spans: int = 0  # launched inside some span
    unmatched: int = 0  # no launch record
    launches: dict = field(default_factory=dict)  # span name (or OUTSIDE) -> kernels, descendants included
    device_s: dict = field(default_factory=dict)  # span name (or OUTSIDE) -> those kernels' device seconds
    unmatched_names: dict = field(default_factory=dict)  # kernel name -> unmatched events

    @property
    def outside(self) -> int:
        return self.launches.get(OUTSIDE, 0)


@dataclass
class Readings:
    """What the span metrics read: the program's span records (set-up's and
    the traced window's), the traced window on the profiler's clock
    (seconds), and the window's kernels by span (None without a profile)."""

    records: list
    window: Optional[tuple[float, float]] = None
    attribution: Optional[Attribution] = None

    def in_window(self, name: str) -> list:
        """The records named `name` that start inside the traced window."""
        if self.window is None:
            return []
        w0, w1 = self.window
        return [r for r in self.records if r.name == name and w0 <= r.start_ns / 1e9 < w1]

    def per_op(self, ops: int, name: str, what: str = "launches") -> Optional[float]:
        """Kernels (`what` = "launches") or their device seconds ("device_s")
        launched inside span `name` per traced call; None where the span did
        not run in the window."""
        if self.attribution is None or not ops or not self.in_window(name):
            return None
        return getattr(self.attribution, what).get(name, 0) / ops

    def host_s(self, name: str) -> Optional[float]:
        """Host seconds of every record named `name`; None where none ran."""
        found = [r.elapsed for r in self.records if r.name == name]
        return sum(found) if found else None


def timelines(records) -> dict[int, tuple[list[int], list[Optional[int]]]]:
    """Per thread (its id's low 32 bits), the innermost open span over
    time: (boundary stamps,
    span id from each boundary on, None outside every span), the
    boundaries in the order they happened (a depth-first walk of the span
    tree, children by id: the order they started)."""
    by_id = {r.id: r for r in records}
    kids: dict[Optional[int], list] = defaultdict(list)
    for r in records:
        kids[r.parent if r.parent in by_id else None].append(r)
    out: dict[int, tuple[list[int], list[Optional[int]]]] = {}

    def walk(r, up: Optional[int], times: list, ids: list) -> None:
        times.append(r.start_ns)
        ids.append(r.id)
        for c in sorted(kids[r.id], key=lambda c: c.id):
            walk(c, r.id, times, ids)
        times.append(r.end_ns)
        ids.append(up)

    for r in sorted(kids[None], key=lambda r: r.id):
        times, ids = out.setdefault(r.thread & TID_MASK, ([], []))
        walk(r, None, times, ids)
    return out


def join(kernels, launches: dict, records) -> Attribution:
    """Put each kernel down to a span.  `kernels`: (start_ns, duration_ns,
    correlation id, name) of the window's kernel events; `launches`:
    correlation id -> (timestamp ns, thread id) of the launch records (the
    thread as CUPTI gives it: `TID_MASK` bits of the span records' ids);
    `records`: the program's span records."""
    lines = timelines(records)
    by_id = {r.id: r for r in records}
    out = Attribution(kernels=len(kernels))
    count: Counter = Counter()
    secs: dict = defaultdict(float)
    unmatched: Counter = Counter()
    for _, dur, corr, name in kernels:
        hit = launches.get(corr)
        if hit is None:
            unmatched[name] += 1
            continue
        ts, tid = hit
        sid = None
        if tid & TID_MASK in lines:
            times, ids = lines[tid & TID_MASK]
            i = bisect.bisect_right(times, ts) - 1
            sid = ids[i] if i >= 0 else None
        count[sid] += 1
        secs[sid] += dur / 1e9
    out.unmatched = sum(unmatched.values())
    out.unmatched_names = dict(unmatched.most_common())
    out.in_spans = sum(n for sid, n in count.items() if sid is not None)
    for sid, n in count.items():
        names, up = ({OUTSIDE} if sid is None else set()), sid
        while up is not None:  # the span and its ancestors, each name once
            names.add(by_id[up].name)
            up = by_id[up].parent if by_id[up].parent in by_id else None
        for name in names:
            out.launches[name] = out.launches.get(name, 0) + n
            out.device_s[name] = out.device_s.get(name, 0.0) + secs[sid]
    return out


def read_profile(prof, window: tuple[float, float]) -> tuple[list, dict]:
    """(kernels, launches) of a torch.profiler profile, as `join` takes
    them: the kernel events that start in `window` (profiler seconds; the
    test `trace.summarize` makes, on the same floats) and the launch records
    by correlation id (the earliest, where both a runtime and a driver
    record carry it)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    w0, w1 = window
    kernels, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue
            name = e.name()
            if w0 <= e.start_ns() / 1e9 < w1 and not name.startswith(("Memcpy", "Memset")):
                kernels.append((e.start_ns(), e.duration_ns(), e.correlation_id(), name))
        elif e.name().startswith(LAUNCH_PREFIXES):
            corr, ts = e.correlation_id(), e.start_ns()
            if corr not in launches or ts < launches[corr][0]:
                launches[corr] = (ts, e.device_resource_id())  # CUPTI's thread id; start_thread_id is torch's own
    return kernels, launches


class Capture:
    """What `install` keeps for `of`: the program's profiler, and the
    profile and window the harness's trace reading was handed."""

    def __init__(self, profiler):
        self.profiler = profiler
        self.prof = None
        self.window: Optional[tuple[float, float]] = None


CAPTURE: Optional[Capture] = None  # set by `install`, once per process


def install() -> Optional[Capture]:
    """Turn the program's spans on and keep the traced run's profile and
    window (see the module's docstring); None against a program whose
    profiler keeps no records."""
    global CAPTURE
    if CAPTURE is not None:
        return CAPTURE
    from sirius_tpu_torch.util.profiling import profiler

    if not hasattr(profiler, "drain"):
        return None
    cap = Capture(profiler)
    device_events, summarize = trace.device_events, trace.summarize

    def kept_device_events(prof):
        cap.prof = prof
        return device_events(prof)

    def kept_summarize(events, window, offset, *rest):
        cap.window = (window[0] + offset, window[1] + offset)
        return summarize(events, window, offset, *rest)

    trace.device_events, trace.summarize = kept_device_events, kept_summarize
    profiler.drain()
    profiler.enable()
    CAPTURE = cap
    return cap


def of(run) -> Optional[Readings]:
    """The run's span readings: kept on the run (`span_readings`), made by
    the first call from what `install` captured; None without a capture."""
    found = getattr(run, "span_readings", None)
    if found is not None or CAPTURE is None:
        return found
    cap = CAPTURE
    readings = Readings(records=cap.profiler.drain(), window=cap.window)
    if cap.prof is not None and cap.window is not None:
        kernels, launches = read_profile(cap.prof, cap.window)
        readings.attribution = att = join(kernels, launches, readings.records)
        counted = getattr(getattr(run, "trace", None), "launches", None)
        print(f"[port_bench spans] {att.kernels} kernels in the traced window ({counted} "
              f"counted by launches_per_step): {att.in_spans} launched in spans, {att.outside} outside any span, "
              f"unmatched {att.unmatched}" + "".join(f"; {n} x {k[:80]}" for k, n in
                                                     list(att.unmatched_names.items())[:8]),
              file=sys.stderr, flush=True)
        ops = max(getattr(run, "ops", 0), 1)
        top = sorted(att.launches.items(), key=lambda kv: -kv[1])[:16]
        print("[port_bench spans] a traced call: " + ", ".join(
            f"{name} {n / ops:.1f} launches {att.device_s[name] / ops:.6f} s" for name, n in top),
              file=sys.stderr, flush=True)
    cap.prof = None  # the profile's events are read; let them go
    run.span_readings = readings
    return readings
