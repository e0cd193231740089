"""The roofline's work counts from shapes, and the readers built on them."""

from __future__ import annotations

import pytest
import torch

from port_bench import harness
from port_bench.roofline.commit import PEAKS, commit_bytes, least_seconds
from port_bench.trace import CommitCall, CommitRecorder, DeviceTrace


def test_commit_bytes_by_hand():
    # the trivial step's W round: 917,504 scalars of 32 bytes, as many key
    # points of 64, one result point of 64
    assert commit_bytes(917_504, 917_504, 1) == 29_360_128 + 58_720_256 + 64
    assert commit_bytes(0, 0, 0) == 0
    assert least_seconds(917_504, 917_504, 1) == pytest.approx(88_080_448 / 3.35e12)
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12


def test_recorded_sizes_of_each_commit_entry():
    size = CommitRecorder._size
    assert size("commit_device", (torch.zeros(5, 8),)) == (5, 5, 1)
    assert size("commit_device_many", (torch.zeros(3, 7, 8),)) == (21, 7, 3)
    pairs = [(torch.zeros(4, 8), None), (torch.zeros(9, 8), None)]
    assert size("batched_commit_check", (pairs,)) == (13, 9, 1)


def _run(op, commits, device_s):
    run = harness.Run(op=op, ops=2, window_s=10.0, setup_s=1.0, pp_s=1.0)
    run.trace = DeviceTrace(window_s=10.0, busy_s=1.5, launches=1000, device_ops=[], idle_by_span=[],
                            commits=commits, commit_device_s=device_s)
    return run


def test_msm_roofline_reads_least_time_over_device_time():
    calls = [CommitCall("bn256", 1000, 1000, 1), CommitCall("grumpkin", 500, 500, 1)]
    want = 100 * (commit_bytes(1000, 1000, 1) + commit_bytes(500, 500, 1)) / 3.35e12 / 0.002
    assert harness.load_reader("msm_roofline.steps")(_run("next", calls, 0.002)) == pytest.approx(want)
    assert harness.load_reader("msm_roofline.steps")(_run("verify", calls, 0.002)) is None  # not a steps run
    assert harness.load_reader("msm_roofline.steps")(_run("next", [], 0.0)) is None  # nothing to read, never 0


def test_idle_share_and_launches():
    run = _run("next", [], 0.0)
    assert harness.load_reader("device_idle_pct.steps")(run) == pytest.approx(85.0)
    assert harness.load_reader("device_idle_pct.steps")(_run("verify", [], 0.0)) is None
    assert harness.load_reader("launches_per_step")(run) == 500
