"""Span-style profiling: host timers over named phases.

The port's own copy of `sirius_tpu/util/profiling.py`: span names mirror the
reference's hot-phase names; off unless SIRIUS_TPU_PROFILE is set, and then
each span's host time is kept in a tree (and appended as a JSON line to
SIRIUS_TPU_PROFILE_JSON when that is set).
"""

from __future__ import annotations

import contextlib
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
    start: float
    children: list = field(default_factory=list)
    elapsed: float = 0.0


class Profiler:
    """Collects a span tree; enable with SIRIUS_TPU_PROFILE=1 or
    `profiler.enable()`."""

    def __init__(self):
        self.enabled = os.environ.get("SIRIUS_TPU_PROFILE", "0") not in ("0", "")
        self.roots: list[Span] = []
        self.json_stream = os.environ.get("SIRIUS_TPU_PROFILE_JSON")

    def enable(self):
        self.enabled = True

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        stack = getattr(_state, "stack", None)
        if stack is None:
            stack = _state.stack = []
        s = Span(name, time.perf_counter())
        (stack[-1].children if stack else self.roots).append(s)
        stack.append(s)
        try:
            yield
        finally:
            stack.pop()
            s.elapsed = time.perf_counter() - s.start
            if self.json_stream:
                with open(self.json_stream, "a") as f:
                    f.write(
                        json.dumps(
                            {"span": s.name, "elapsed_ms": s.elapsed * 1e3, "depth": len(stack)}
                        )
                        + "\n"
                    )

    def report(self, out=None):
        out = out or sys.stderr  # read at the call: the stream may have been replaced since import

        def walk(spans, depth):
            for s in spans:
                print(f"{'  ' * depth}{s.name}: {s.elapsed * 1e3:.2f} ms", file=out)
                walk(s.children, depth + 1)

        walk(self.roots, 0)


profiler = Profiler()
span = profiler.span
