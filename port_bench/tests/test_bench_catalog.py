"""The benchmark's catalog: BENCHMARK.json against the contract's shapes, and
every configuration, traffic mix and metric found by name."""

from __future__ import annotations

import json
import re

import pytest

from port_bench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.load_benchmark()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in METRICS] + [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in METRICS}) == len(METRICS)


def test_entries_hold_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_cell_finds_its_configuration_mix_and_metrics_by_name(cell):
    w = harness.cell_of(BENCH, cell)
    cfg = harness.load_config(w["config"])
    assert cfg["name"] == w["config"]
    assert harness.load_traffic(w["traffic"])["op"] == "next"
    e2e = harness.metrics_of_cell(BENCH, cell, trace=False)
    layers = harness.metrics_of_cell(BENCH, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layers
    for m in e2e + layers:
        assert callable(harness.load_reader(m["name"]))
        assert m.get("moves", m["name"]) in {e["name"] for e in e2e}


def test_config_files_are_their_own_and_lie_under_paths():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
        cfg = harness.load_config(c["name"])
        assert set(c["reduced"]) == set(cfg["reduced"])


def test_each_configuration_holds_the_jax_packages_pp_digest():
    for c in BENCH["configs"]:
        digest = harness.load_config(c["name"])["pp_digest_jax"]
        assert re.fullmatch(r"[0-9a-f]{128}", digest), c["name"]


def test_readers_leave_out_what_a_run_cannot_read():
    run = harness.Run(op="next", ops=3, window_s=6.0, setup_s=20.0, pp_s=5.0,
                      peak_by_call=[2**30, 2**31, 2**31, 3 * 2**30])
    assert harness.load_reader("step_s")(run) == 2.0
    assert harness.load_reader("step_s")(harness.Run(op="next", ops=0, window_s=6.0, setup_s=20.0, pp_s=5.0)) is None
    assert harness.load_reader("peak_mem_first3_gib")(run) == 2.0  # as the third call ended
    assert harness.load_reader("peak_mem_first3_gib")(harness.Run(op="next", ops=2, window_s=6.0, setup_s=20.0,
                                                                  pp_s=5.0, peak_by_call=[1, 2])) is None
    assert harness.load_reader("pg_prove_s")(run) is None  # no spans: untraced
    assert harness.load_reader("device_idle_pct.steps")(run) is None
    run.spans = {"pg_prove": 4.5, "compute_K": 3.0}
    assert harness.load_reader("pg_prove_s")(run) == 1.5
    assert harness.load_reader("support_folds_s")(run) is None


def test_z0_depends_on_the_seed_alone():
    cfg = harness.load_config("cf_trivial_k17")
    p = 2**61 - 1
    big = 2**31 + 987654321
    assert harness.z0_of(cfg, big, p) == harness.z0_of(cfg, big, p)
    assert harness.z0_of(cfg, big, p) != harness.z0_of(cfg, big + 1, p)
