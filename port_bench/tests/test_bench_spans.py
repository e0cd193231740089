"""Kernels put down to the program's spans (`port_bench/spans.py`), on
hand-built span records and profiler events, and the readers built on
them."""

from __future__ import annotations

import pytest

from sirius_tpu_torch.util import profiling
from sirius_tpu_torch.util.profiling import Span

from port_bench import harness, spans, trace
from port_bench.roofline.commit import least_seconds
from port_bench.spans import OUTSIDE, Attribution, Readings, join, read_profile, timelines

TID = 4242
NEW_READERS = ("compute_K_launches", "compute_K_device_s", "support_folds_launches", "sps_primary_launches",
               "commit_roofline.steps", "public_params_s", "keys_s")


@pytest.fixture(autouse=True)
def no_capture(monkeypatch):
    """Each test starts without a capture and leaves the harness's trace
    functions and the program's profiler as it found them."""
    monkeypatch.setattr(spans, "CAPTURE", None)
    monkeypatch.setattr(trace, "device_events", trace.device_events)
    monkeypatch.setattr(trace, "summarize", trace.summarize)
    real = profiling.profiler
    was = real.enabled
    yield
    real.enabled = was
    real.drain()


def rec(name, id, parent, start, end, step=None, thread=TID, counts=None):
    """A span record stamped in ns."""
    return Span(name, start / 1e9, [], (end - start) / 1e9, id=id, parent=parent, step=step, thread=thread,
                start_ns=start, end_ns=end, counts=counts)


def _records():
    # pp [0, 50) in set-up; next [100, 200): pg_prove [110, 150) holding compute_K
    # [120, 140), commit [160, 170); a second thread's span [100, 200)
    return [
        rec("public_params", 1, None, 0, 50),
        rec("compute_K", 4, 3, 120, 140, step=2),
        rec("pg_prove", 3, 2, 110, 150, step=2),
        rec("commit", 5, 2, 160, 170, step=2, counts={"scalars": 1000, "points": 1000, "results": 1}),
        rec("next", 2, None, 100, 200, step=2),
        rec("other", 6, None, 100, 200, thread=7),
    ]


def test_the_innermost_span_over_time_per_thread():
    lines = timelines(_records())
    times, ids = lines[TID]
    assert times == [0, 50, 100, 110, 120, 140, 150, 160, 170, 200]
    assert ids == [1, None, 2, 3, 4, 3, 2, 5, 2, None]
    assert lines[7] == ([100, 200], [6, None])


def test_join_by_correlation_and_innermost_span():
    kernels = [(300, 10, 1, "a"), (301, 20, 2, "b"), (302, 30, 3, "c"), (303, 40, 4, "d"), (304, 50, 5, "e"),
               (305, 60, 6, "f")]
    launches = {1: (125, TID),  # in compute_K
                2: (115, TID),  # in pg_prove, outside compute_K
                3: (165, TID),  # in commit
                4: (250, TID),  # after every span
                5: (125, 7),  # on the other thread, in its span
                6: (105, 99)}  # a thread that ran no span
    att = join(kernels, launches, _records())
    assert att.kernels == 6 and att.unmatched == 0
    assert att.in_spans == 4 and att.outside == 2
    assert att.launches == {"compute_K": 1, "pg_prove": 2, "next": 3, "commit": 1, "other": 1, OUTSIDE: 2}
    assert att.device_s["compute_K"] == pytest.approx(10e-9)
    assert att.device_s["pg_prove"] == pytest.approx(30e-9)
    assert att.device_s["next"] == pytest.approx(60e-9)
    assert att.device_s[OUTSIDE] == pytest.approx(100e-9)


def test_a_span_counts_its_descendants_each_name_once():
    # an inner span of the same name as its ancestor: its kernels count once
    records = [rec("fold", 1, None, 0, 100), rec("fold", 2, 1, 10, 50), rec("leaf", 3, 2, 20, 30)]
    att = join([(0, 1, 1, "k"), (0, 1, 2, "k"), (0, 1, 3, "k")], {1: (25, TID), 2: (40, TID), 3: (60, TID)}, records)
    assert att.launches == {"leaf": 1, "fold": 3}


def test_kernels_without_a_launch_record_are_unmatched():
    kernels = [(0, 5, 1, "msm_accumulate"), (0, 5, 2, "msm_accumulate"), (0, 5, 3, "add"), (0, 5, 4, "add")]
    att = join(kernels, {3: (125, TID)}, _records())
    assert att.unmatched == 3 and att.unmatched_names == {"msm_accumulate": 2, "add": 1}
    assert att.in_spans == 1 and att.outside == 0
    assert att.in_spans + att.outside + att.unmatched == att.kernels


class Event:
    """A kineto event as the profiler hands it over."""

    def __init__(self, name, start_ns, dur_ns, corr, cuda=True, tid=TID):
        self._v = (name, start_ns, dur_ns, corr, cuda, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        import torch

        return torch.autograd.DeviceType.CUDA if self._v[4] else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return False

    def device_resource_id(self):
        return self._v[5]


class Prof:
    def __init__(self, events):
        kineto = type("K", (), {"events": lambda _: events})()
        self.profiler = type("P", (), {"kineto_results": kineto})()


def _profile():
    """Host clock = profiler clock - 100 s; window [0, 10) on the host.  Two
    kernels in spans (one with a driver record alone), one launched outside
    every span, one with no launch record, a memcpy, a kernel before the
    window and a fill."""
    s = 1_000_000_000
    return Prof([
        Event("early", 99 * s, s // 2, 1), Event("cudaLaunchKernel", 99 * s - 10, 5, 1, cuda=False),
        Event("compute_k_add", 100 * s + 500, 1000, 2), Event("cudaLaunchKernel", 100 * s + 125, 9, 2, cuda=False),
        Event("cuLaunchKernel", 100 * s + 126, 3, 2, cuda=False),
        Event("msm_reduce", 100 * s + 900, 2000, 3), Event("cuLaunchKernel", 100 * s + 165, 5, 3, cuda=False),
        Event("later", 101 * s, 3000, 4), Event("cudaLaunchKernel", 100 * s + 400, 5, 4, cuda=False),
        Event("lost", 102 * s, 4000, 5),
        Event("Memcpy HtoD", 103 * s, 100, 6), Event("cudaMemcpyAsync", 103 * s - 50, 5, 6, cuda=False),
        Event("Memset (Device)", 104 * s, 100, 7),
    ])


def _records_at(offset_ns):
    return [rec(r.name, r.id, r.parent, r.start_ns + offset_ns, r.end_ns + offset_ns, r.step, r.thread, r.counts)
            for r in _records()]


def test_attributed_outside_and_unmatched_sum_to_the_launch_count():
    prof = _profile()
    window, offset = (0.0, 10.0), 100.0
    counted = trace.summarize(trace.device_events(prof), window, offset, [], []).launches
    kernels, launches = read_profile(prof, (window[0] + offset, window[1] + offset))
    assert [k[3] for k in kernels] == ["compute_k_add", "msm_reduce", "later", "lost"]
    assert launches[2] == (100_000_000_125, TID)  # the runtime record, the earlier of two
    att = join(kernels, launches, _records_at(100_000_000_000))
    assert (att.in_spans, att.outside, att.unmatched) == (2, 1, 1)
    assert att.in_spans + att.outside + att.unmatched == att.kernels == counted == 4
    assert att.launches["compute_K"] == 1 and att.launches["commit"] == 1 and att.launches["next"] == 2


def _run(readings=None, ops=2):
    run = harness.Run(op="next", ops=ops, window_s=10.0, setup_s=30.0, pp_s=5.0)
    if readings is not None:
        run.span_readings = readings
    return run


def _readers(monkeypatch):
    monkeypatch.setattr(spans, "install", lambda: None)
    return {name: harness.load_reader(name) for name in NEW_READERS}


def test_each_new_reader(monkeypatch):
    read = _readers(monkeypatch)
    records = _records() + [rec("commitment_key", 7, None, 0, 20), rec("commitment_key", 8, None, 20, 30),
                            rec("ck_load", 9, 8, 21, 29)]
    att = Attribution(kernels=40, in_spans=36, launches={"compute_K": 10, "pg_prove": 16, "next": 36,
                                                         "commit": 6, OUTSIDE: 4},
                      device_s={"compute_K": 0.5, "commit": 0.25, "next": 1.0})
    r = Readings(records=records, window=(90e-9, 300e-9), attribution=att)
    run = _run(r)
    assert read["compute_K_launches"](run) == 5.0
    assert read["compute_K_device_s"](run) == 0.25
    assert read["support_folds_launches"](run) is None  # no support_folds span ran in the window
    assert read["sps_primary_launches"](run) is None
    want = 100 * least_seconds(1000, 1000, 1) / 0.25
    assert read["commit_roofline.steps"](run) == pytest.approx(want)
    assert read["public_params_s"](run) == pytest.approx(50e-9)
    assert read["keys_s"](run) == pytest.approx(30e-9)  # both keys; ck_load lies inside its key's span
    # a span that ran but launched nothing reads 0
    r.records.append(rec("support_folds", 10, 2, 175, 180, step=2))
    assert read["support_folds_launches"](run) == 0.0


def test_the_readers_leave_out_what_a_run_cannot_read(monkeypatch):
    read = _readers(monkeypatch)
    for name in NEW_READERS:  # no capture (an untraced run, or a program without span records)
        assert read[name](_run()) is None
    no_profile = _run(Readings(records=_records()))
    assert read["compute_K_launches"](no_profile) is None
    assert read["commit_roofline.steps"](no_profile) is None
    assert read["public_params_s"](no_profile) == pytest.approx(50e-9)
    assert read["keys_s"](no_profile) is None


def test_install_does_nothing_against_a_program_without_records(monkeypatch):
    class OldProfiler:  # the parent's profiler: a tree of host times, no records
        enabled = False
        roots: list = []

    monkeypatch.setattr(profiling, "profiler", OldProfiler())
    device_events = trace.device_events
    assert spans.install() is None
    assert spans.CAPTURE is None and trace.device_events is device_events
    assert spans.of(_run()) is None


def test_install_captures_the_traced_window_and_of_joins_it():
    cap = spans.install()
    assert cap is not None and spans.install() is cap and profiling.profiler.enabled
    # the harness's reading goes through the wrapped functions, unchanged
    prof = _profile()
    tr = trace.summarize(trace.device_events(prof), (0.0, 10.0), 100.0, [], [])
    assert tr.launches == 4 and cap.prof is prof and cap.window == (100.0, 110.0)
    profiling.profiler.records.extend(_records_at(100_000_000_000))
    run = _run(ops=1)
    run.trace = tr
    r = spans.of(run)
    assert r is run.span_readings and spans.of(run) is r
    assert profiling.profiler.records == [] and cap.prof is None
    assert r.attribution.kernels == tr.launches and r.attribution.unmatched == 1
    assert r.per_op(1, "compute_K") == 1 and r.per_op(1, "commit", "device_s") == pytest.approx(2e-6)
