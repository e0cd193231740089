"""Span-style profiling: named phases of the program, kept in memory.

The port's own copy of `sirius_tpu/util/profiling.py`: span names mirror the
reference's hot-phase names.  Off unless SIRIUS_TPU_PROFILE is set (or
`profiler.enable()`); then each span keeps its host seconds in a tree
(`roots`, each span's `children`) and, once it ends, is recorded with an id,
its parent's id, the step it belongs to (the `step` given to a span and to
every span under it), its thread, stamps on the clock of
`torch.profiler`'s events (Unix ns) and an optional dict of counts.
`drain()` hands the records over and clears them.  With
SIRIUS_TPU_PROFILE_JSON set, every record of the run is written to that file
as JSON lines once, at exit (`write_json`).  Off, a span reads no clock and
records nothing.
"""

from __future__ import annotations

import atexit
import contextlib
import itertools
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

_state = threading.local()


@dataclass
class Span:
    name: str
    start: float  # perf_counter seconds
    children: list = field(default_factory=list)
    elapsed: float = 0.0  # perf_counter seconds
    id: int = 0
    parent: Optional[int] = None  # the enclosing span's id
    step: Optional[int] = None  # the step this span belongs to (None outside a step)
    depth: int = 0  # enclosing spans on its thread
    thread: int = 0  # threading.get_ident() of the thread that ran it (CUPTI's launch records carry its low 32 bits)
    start_ns: int = 0  # time.time_ns(): the Unix-ns clock torch.profiler puts its events on
    end_ns: int = 0
    counts: Optional[dict] = None

    def line(self) -> dict:
        """The record as a JSON line's object."""
        out = {"span": self.name, "elapsed_ms": self.elapsed * 1e3, "depth": self.depth, "id": self.id,
               "parent": self.parent, "step": self.step, "thread": self.thread, "start_ns": self.start_ns,
               "end_ns": self.end_ns}
        if self.counts:
            out["counts"] = self.counts
        return out


class Profiler:
    """Collects spans; enable with SIRIUS_TPU_PROFILE=1 or `profiler.enable()`."""

    def __init__(self):
        self.enabled = os.environ.get("SIRIUS_TPU_PROFILE", "0") not in ("0", "")
        self.roots: list[Span] = []
        self.records: list[Span] = []  # ended spans since the last drain, in the order they ended
        self.json_path = os.environ.get("SIRIUS_TPU_PROFILE_JSON")
        self._drained: list[Span] = []  # records drained while json_path is set, for `write_json`
        self._ids = itertools.count(1)
        if self.json_path:
            atexit.register(self.write_json)

    def enable(self):
        self.enabled = True

    @contextlib.contextmanager
    def span(self, name: str, step: Optional[int] = None, counts: Optional[dict] = None):
        """Time the body as span `name`; yields its record (None when off)."""
        if not self.enabled:
            yield None
            return
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        up = stack[-1] if stack else None
        s = Span(name, time.perf_counter(), id=next(self._ids), parent=up and up.id,
                 step=step if step is not None or up is None else up.step, depth=len(stack),
                 thread=threading.get_ident(), counts=counts)
        (up.children if up else self.roots).append(s)
        stack.append(s)
        s.start_ns = time.time_ns()
        try:
            yield s
        finally:
            s.end_ns = time.time_ns()
            s.elapsed = time.perf_counter() - s.start
            stack.pop()
            self.records.append(s)

    def is_open(self, name: str) -> bool:
        """Whether a span named `name` is open on this thread."""
        return any(s.name == name for s in getattr(_state, "stack", ()))

    def totals(self) -> dict[str, float]:
        """Host seconds per span name over the records not yet drained."""
        out: dict[str, float] = {}
        for s in self.records:
            out[s.name] = out.get(s.name, 0.0) + s.elapsed
        return out

    def drain(self) -> list[Span]:
        """The records of the spans ended since the last drain; they and the
        span tree are then cleared."""
        out, self.records = self.records, []
        self.roots.clear()
        if self.json_path:
            self._drained.extend(out)
        return out

    def write_json(self, path: Optional[str] = None) -> None:
        """Append every record of the run (those drained since `json_path`
        was set, then the rest) to `path` (default `json_path`) as JSON
        lines, and forget them."""
        path = path or self.json_path
        if not path:
            return
        done, self._drained, self.records = self._drained + self.records, [], []
        with open(path, "a") as f:
            for s in done:
                f.write(json.dumps(s.line()) + "\n")

    def report(self, out=None):
        out = out or sys.stderr  # read at the call: the stream may have been replaced since import

        def walk(spans, depth):
            for s in spans:
                print(f"{'  ' * depth}{s.name}: {s.elapsed * 1e3:.2f} ms", file=out)
                walk(s.children, depth + 1)

        walk(self.roots, 0)


profiler = Profiler()
span = profiler.span
