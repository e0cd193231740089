"""The traced run's readings: the program's host spans, the device's events
from `torch.profiler`, and the commits' intervals.

The profiler traces device activity only (CUDA, no host operator events),
and its raw kineto events are read once: host operator events would double
the events of a k = 18 step (~320,000 kernels) and the time to stop the
profiler and read them, and the parsed event tree takes minutes.  The
harness's commit wrapper synchronizes the device before and after each
outermost commit call, so the kernels a commit launched are the device
events that start inside its interval.  Host readings (`perf_counter`:
spans, commit intervals, the window) are put on the profiler's clock by one
reading of both clocks when tracing starts.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

COMMIT_METHODS = ("commit_device", "commit_device_many", "batched_commit_check")
OUTSIDE = "outside any span"


@dataclass
class CommitCall:
    curve: str
    scalars: int  # scalars read by the commit
    points: int  # key points read
    results: int  # points written
    start: float = 0.0  # perf_counter, after a device synchronize
    end: float = 0.0  # perf_counter, after a device synchronize


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float  # union of the device events' intervals
    launches: int  # kernel events (copies and fills not counted)
    device_ops: list  # [name, seconds] by total time
    idle_by_span: list  # [innermost open span, idle seconds]
    commits: list = field(default_factory=list)  # CommitCall per outermost commit call
    commit_device_s: float = 0.0  # device seconds of the events that ran inside the commits


class CommitRecorder:
    """Wraps the commit layer's entry points (`CommitmentKey.commit_device`,
    `commit_device_many`, `batched_commit_check`): each outermost call is
    closed on both sides by a device synchronize and recorded with its size
    and interval."""

    def __init__(self, key_class, sync):
        self.key_class = key_class
        self.sync = sync
        self.calls: list[CommitCall] = []
        self.depth = 0
        self.saved = {}

    @staticmethod
    def _size(name, args) -> tuple[int, int, int]:
        """(scalars read, key points read, points written) of one call."""
        if name == "commit_device":
            n = int(args[0].shape[0])
            return (n, n, 1)
        if name == "commit_device_many":
            t, n = (int(v) for v in args[0].shape[:2])
            return (t * n, n, t)
        sizes = [int(W.shape[0]) for W, _ in args[0]]
        return (sum(sizes), max(sizes, default=0), 1)

    def _wrap(self, name, fn):
        def wrapped(key, *args, **kwargs):
            if self.depth:
                return fn(key, *args, **kwargs)
            if name == "batched_commit_check":
                args = (list(args[0]), *args[1:])
            call = CommitCall(key.curve.spec.name, *self._size(name, args))
            self.depth += 1
            call.start = self.sync()
            try:
                return fn(key, *args, **kwargs)
            finally:
                call.end = self.sync()
                self.calls.append(call)
                self.depth -= 1

        return wrapped

    def __enter__(self):
        for name in COMMIT_METHODS:
            self.saved[name] = getattr(self.key_class, name)
            setattr(self.key_class, name, self._wrap(name, self.saved[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.key_class, name, fn)
        self.saved.clear()
        return False


def span_totals(roots) -> dict[str, float]:
    """Host seconds per span name over a span forest."""
    totals: dict[str, float] = {}
    stack = list(roots)
    while stack:
        s = stack.pop()
        totals[s.name] = totals.get(s.name, 0.0) + s.elapsed
        stack.extend(s.children)
    return totals


def span_timeline(roots, offset: float = 0.0) -> list[tuple[float, str]]:
    """The innermost open span over time: sorted (start, name) segments, each
    lasting until the next; spans of one thread nest, so a span's own time
    is what its children leave."""
    segs: list[tuple[float, str]] = []

    def walk(spans, parent: str):
        for s in sorted(spans, key=lambda s: s.start):
            segs.append((s.start + offset, s.name))
            walk(s.children, s.name)
            segs.append((s.start + s.elapsed + offset, parent))

    walk(roots, OUTSIDE)
    segs.sort(key=lambda seg: seg[0])
    return segs


class Tracer:
    """The traced part of a window: `torch.profiler` on device activity, the
    program's spans and the commit recorder, from `start` to `stop`."""

    def __init__(self, key_class, sync, spans):
        self.recorder = CommitRecorder(key_class, sync)
        self.spans = spans  # the program's `util.profiling.profiler`
        self.prof = None
        self.on = False
        self.calls = 0
        self.seconds = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.spans.roots.clear()
        self.spans.enable()
        self.recorder.__enter__()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.wall_ns, self.perf = time.time_ns(), time.perf_counter()
        self.on = True

    def stop(self, calls: int, seconds: float) -> None:
        """End tracing after `calls` calls that took `seconds`."""
        self.prof.stop()
        self.spans.enabled = False
        self.recorder.__exit__()
        self.on = False
        self.calls, self.seconds = calls, seconds

    def read(self, t0: float) -> DeviceTrace:
        """The traced part's readings; `t0` is the window's start on the
        host's perf_counter clock."""
        offset = self.wall_ns / 1e9 - self.perf
        return summarize(device_events(self.prof), (t0, t0 + self.seconds), offset, self.recorder.calls,
                         self.spans.roots)


def device_events(prof) -> list[tuple[float, float, str]]:
    """(start, end, name) in profiler seconds of every device event of a
    profile, sorted by start."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            start = e.start_ns() / 1e9
            out.append((start, start + e.duration_ns() / 1e9, e.name()))
    out.sort()
    return out


def summarize(events, window: tuple[float, float], offset: float, commits, span_roots) -> DeviceTrace:
    """The window's device readings: `events` from `device_events`, `window`
    and the commits' intervals on the host's perf_counter clock, `offset` =
    profiler seconds - perf_counter seconds."""
    w0, w1 = window[0] + offset, window[1] + offset
    ranges = sorted((c.start + offset, c.end + offset) for c in commits)
    starts = [r[0] for r in ranges]
    busy, edge = 0.0, w0
    gaps: list[tuple[float, float]] = []
    by_name: dict[str, float] = {}
    launches = 0
    commit_s = 0.0
    for start, end, name in events:
        if not w0 <= start < w1:
            continue
        if start > edge:
            gaps.append((edge, start))
        busy += max(0.0, min(end, w1) - max(start, edge))
        edge = max(edge, end)
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        if not name.startswith(("Memcpy", "Memset")):
            launches += 1
        i = bisect.bisect_right(starts, start) - 1
        if i >= 0 and start < ranges[i][1]:
            commit_s += end - start
    if w1 > edge:
        gaps.append((edge, w1))

    timeline = span_timeline(span_roots, offset)
    seg_starts = [t for t, _ in timeline]
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        i = bisect.bisect_right(seg_starts, g0) - 1
        name = timeline[i][1] if i >= 0 else OUTSIDE
        idle[name] = idle.get(name, 0.0) + (g1 - g0)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return DeviceTrace(window_s=window[1] - window[0], busy_s=busy, launches=launches, device_ops=top(by_name),
                       idle_by_span=top(idle), commits=list(commits), commit_device_s=commit_s)
