"""Span bookkeeping of the traced run, on hand-built span trees."""

from __future__ import annotations

from sirius_tpu_torch.util.profiling import Span

from port_bench.trace import CommitCall, summarize, span_timeline, span_totals


def _tree():
    # next [0, 10): pg_prove [1, 5) holding compute_K [2, 4); support_folds [6, 9)
    k = Span("compute_K", 2.0, [], 2.0)
    pg = Span("pg_prove", 1.0, [k], 4.0)
    sf = Span("support_folds", 6.0, [], 3.0)
    return [Span("next", 0.0, [pg, sf], 10.0)]


def test_span_totals():
    assert span_totals(_tree()) == {"next": 10.0, "pg_prove": 4.0, "compute_K": 2.0, "support_folds": 3.0}


def test_innermost_span_over_time():
    segs = span_timeline(_tree(), offset=100.0)
    def at(t):
        return [name for start, name in segs if start <= t][-1]
    assert at(100.5) == "next"
    assert at(101.5) == "pg_prove"
    assert at(103.0) == "compute_K"
    assert at(104.5) == "pg_prove"
    assert at(105.5) == "next"
    assert at(107.0) == "support_folds"
    assert at(109.5) == "next"
    assert at(111.0) == "outside any span"


def test_summarize_a_window_by_hand():
    """Host clock = profiler clock - 100 s.  Window [0, 10) on the host;
    kernels at 100.5-101.0 (inside a commit at host [0.4, 1.2]), 102.5-103.0,
    103.5-104.0 and a memcpy 107-108; one kernel before the window."""
    events = [(99.0, 99.5, "early"), (100.5, 101.0, "msm"), (102.5, 103.0, "add"), (103.5, 104.0, "add"),
              (107.0, 108.0, "Memcpy HtoD")]
    commit = CommitCall("bn256", 10, 10, 1, start=0.4, end=1.2)
    tr = summarize(events, (0.0, 10.0), 100.0, [commit], _tree())
    assert tr.window_s == 10.0 and tr.launches == 3
    assert tr.busy_s == 0.5 + 0.5 + 0.5 + 1.0
    assert tr.commit_device_s == 0.5
    assert dict(map(tuple, tr.device_ops)) == {"msm": 0.5, "add": 1.0, "Memcpy HtoD": 1.0}
    # idle: [0, 0.5) in next, [1, 2.5) starts in pg_prove, [3, 3.5) in compute_K,
    # [4, 7) starts in pg_prove, [8, 10) starts in support_folds
    assert dict(map(tuple, tr.idle_by_span)) == {"next": 0.5, "pg_prove": 1.5 + 3.0, "compute_K": 0.5,
                                                  "support_folds": 2.0}
