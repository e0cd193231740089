"""The port's span profiler (`sirius_tpu_torch/util/profiling.py`): span
records with ids, parents, steps and Unix-ns stamps, drain / totals, the
JSON export written once at the end, the program's own spans (commits, key
set-up, the support folds) and, on a card, that the stamps share the clock
of torch.profiler's launch records.

Imports no jax, so the card's test runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_profiling.py
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from sirius_tpu_torch.curves.jpoint import GRUMPKIN
from sirius_tpu_torch.fields.jfield import ints_to_words
from sirius_tpu_torch.ivc.support_fold import SupportFoldChain, random_input, support_structure
from sirius_tpu_torch.ops import commitment
from sirius_tpu_torch.ops.commitment import CommitmentKey
from sirius_tpu_torch.util import profiling
from sirius_tpu_torch.util.profiling import Profiler, profiler
from sirius_tpu_torch.util.testing import MockCommitmentKey

torch.set_num_threads(1)  # small ops: more threads only contend with the other test workers


@pytest.fixture
def on():
    """The process's profiler, on and empty, restored after the test."""
    was = profiler.enabled
    profiler.drain()
    profiler.enable()
    yield profiler
    profiler.enabled = was
    profiler.drain()


def _nest(p: Profiler):
    with p.span("next", step=7):
        with p.span("pg_prove"):
            with p.span("compute_K", counts={"rows": 3}):
                time.sleep(0.001)
        with p.span("support_folds"):
            pass
    with p.span("outside"):
        pass


def test_records_carry_ids_parents_steps_and_nested_stamps():
    p = Profiler()
    p.enable()
    t0 = time.time_ns()
    _nest(p)
    t1 = time.time_ns()
    recs = {r.name: r for r in p.records}
    assert [r.name for r in p.records] == ["compute_K", "pg_prove", "support_folds", "next", "outside"]
    nxt, pg, k, sf, out = (recs[n] for n in ("next", "pg_prove", "compute_K", "support_folds", "outside"))
    assert len({r.id for r in p.records}) == 5
    assert (nxt.parent, pg.parent, k.parent, sf.parent, out.parent) == (None, nxt.id, pg.id, nxt.id, None)
    assert (nxt.step, pg.step, k.step, sf.step, out.step) == (7, 7, 7, 7, None)
    assert (nxt.depth, pg.depth, k.depth, out.depth) == (0, 1, 2, 0)
    assert k.counts == {"rows": 3} and nxt.counts is None
    assert {r.thread for r in p.records} == {threading.get_ident()}
    # stamps on the Unix-ns clock, each span inside its parent, siblings in order
    assert t0 <= nxt.start_ns <= pg.start_ns <= k.start_ns < k.end_ns <= pg.end_ns <= sf.start_ns
    assert sf.end_ns <= nxt.end_ns <= out.start_ns <= out.end_ns <= t1
    assert k.end_ns - k.start_ns >= 1_000_000
    # the tree the harness reads is kept as it was
    assert [s.name for s in p.roots] == ["next", "outside"]
    assert [c.name for c in p.roots[0].children] == ["pg_prove", "support_folds"]
    assert p.roots[0].children[0].children[0] is k and k.elapsed >= 0.001


def test_a_disabled_profiler_keeps_nothing(monkeypatch):
    p = Profiler()
    assert not p.enabled

    def no_clock():
        raise AssertionError("a disabled span read a clock")

    monkeypatch.setattr(profiling.time, "perf_counter", no_clock)
    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    with p.span("a", step=1) as s:
        assert s is None
    assert p.records == [] and p.roots == [] and p.totals() == {} and p.drain() == []


def test_drain_and_totals():
    p = Profiler()
    p.enable()
    _nest(p)
    _nest(p)
    totals = p.totals()
    assert set(totals) == {"next", "pg_prove", "compute_K", "support_folds", "outside"}
    assert totals["compute_K"] == pytest.approx(sum(r.elapsed for r in p.records if r.name == "compute_K"))
    assert totals["next"] >= totals["pg_prove"] >= totals["compute_K"] >= 0.002
    got = p.drain()
    assert len(got) == 10 and p.records == [] and p.roots == [] and p.totals() == {}
    _nest(p)
    assert len(p.drain()) == 5


def test_json_export_written_once_at_the_end(tmp_path, monkeypatch):
    path = tmp_path / "spans.jsonl"
    monkeypatch.setenv("SIRIUS_TPU_PROFILE", "1")
    monkeypatch.setenv("SIRIUS_TPU_PROFILE_JSON", str(path))
    registered = []
    monkeypatch.setattr(profiling.atexit, "register", registered.append)
    p = Profiler()
    assert p.enabled and registered == [p.write_json]
    _nest(p)
    assert not path.exists()  # no span exit writes the file
    drained = p.drain()
    _nest(p)
    p.write_json()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == 10
    assert [ln["span"] for ln in lines[:5]] == [r.name for r in drained]
    for ln in lines:
        assert {"span", "elapsed_ms", "depth", "id", "parent", "step", "thread", "start_ns", "end_ns"} <= set(ln)
    first = {ln["span"]: ln for ln in lines[:5]}
    assert first["compute_K"]["depth"] == 2 and first["next"]["depth"] == 0
    assert first["compute_K"]["counts"] == {"rows": 3} and "counts" not in first["next"]
    assert first["pg_prove"]["parent"] == first["next"]["id"] and first["pg_prove"]["step"] == 7
    assert first["compute_K"]["elapsed_ms"] >= 1.0
    p.write_json()  # nothing left: the file is not written twice
    assert len(path.read_text().splitlines()) == 10


def test_cli_writes_the_profile_at_the_end(tmp_path, monkeypatch):
    from sirius_tpu_torch.examples import cli

    path = tmp_path / "cli.jsonl"
    seen = []

    class Example:
        @staticmethod
        def main(argv):
            with profiler.span("fold"):
                pass
            seen.append(path.exists())
            return 0

    monkeypatch.setattr(cli.importlib, "import_module", lambda name: Example)
    was = profiler.enabled
    profiler.drain()
    try:
        assert cli.main(["sangria-instances", "--cpu", "--profile-json", str(path)]) == 0
    finally:
        profiler.enabled, profiler.json_path = was, None
    assert seen == [False]
    assert [json.loads(line)["span"] for line in path.read_text().splitlines()] == ["fold"]


def _words(curve, n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    vals = [int(v) for v in rng.integers(1, 1 << 60, size=n)]
    return curve.fs.to_mont(torch.from_numpy(ints_to_words(vals)))


def test_commit_spans_outermost_with_counts(on, tmp_path, monkeypatch):
    monkeypatch.setattr(commitment, "CACHE_DIR", str(tmp_path))
    ck = CommitmentKey.setup(GRUMPKIN, 5, b"profiling-test", device="cpu")
    ck2 = CommitmentKey.setup(GRUMPKIN, 5, b"profiling-test", device="cpu")
    setup = on.drain()
    assert [r.name for r in setup] == ["ck_derive", "commitment_key", "ck_load", "commitment_key"]
    assert setup[0].parent == setup[1].id and setup[2].parent == setup[3].id
    assert ck2.points.x.equal(ck.points.x)

    a, b = _words(GRUMPKIN, 20, 1), _words(GRUMPKIN, 12, 2)
    C = ck.commit_device(a)
    many = ck.commit_device_many(torch.stack([a[:12], b]))
    assert ck.batched_commit_check([(a, C), (b, many[1])]) == []
    assert ck.batched_commit_check(iter([(a, C)])) == []
    recs = on.drain()
    assert [r.name for r in recs] == ["commit"] * 4  # the checks' inner commits open none
    assert [r.counts for r in recs] == [
        {"scalars": 20, "points": 20, "results": 1},
        {"scalars": 24, "points": 12, "results": 2},
        {"scalars": 32, "points": 20, "results": 1},
        {"scalars": 20, "points": 20, "results": 1},
    ]
    assert all(r.parent is None for r in recs)


def test_support_fold_spans_without_a_synchronize(on, monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: syncs.append(a))
    chain = SupportFoldChain(MockCommitmentKey(GRUMPKIN, "cpu"), *support_structure())
    on.drain()
    assert chain.fold(random_input(np.random.default_rng(3))) is None
    names = [r.name for r in on.drain()]
    assert [n for n in names if n.startswith("support_")] == ["support_witness", "support_sps",
                                                            "support_sangria_prove"]
    assert syncs == []
    assert len(chain.incoming) == len(chain.cross) == 1 and chain.is_sat() == []


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_span_stamps_share_the_profilers_clock(cuda_device, on):
    """The kernel library's add_one launched inside a span: its launch
    record (runtime or driver) falls between the span's stamps, carries the
    low 32 bits of the span's thread id, and its kernel runs after the
    launch."""
    from torch.profiler import ProfilerActivity, profile

    from sirius_tpu_torch.ops import microbench as mb

    x = torch.arange(1024, dtype=torch.int64, device=cuda_device)
    mb.probe_add_one(x)  # build and load the library outside the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with on.span("launch") as s:
            y = mb.probe_add_one(x)
        torch.cuda.synchronize()
    assert torch.equal(y, x + 1)
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type() == cuda and "add_one" in e.name()]
    assert len(kernels) == 1
    corr = kernels[0].correlation_id()
    launches = [e for e in events if e.device_type() != cuda and e.correlation_id() == corr
                and "aunch" in e.name()]
    assert launches, "no launch record shares the kernel's correlation id"
    for launch in launches:
        assert s.start_ns <= launch.start_ns() <= s.end_ns
        assert launch.device_resource_id() & 0xFFFFFFFF == s.thread & 0xFFFFFFFF
        assert launch.start_ns() <= kernels[0].start_ns()
