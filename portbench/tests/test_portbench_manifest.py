"""BENCHMARK.json against the rules a benchmark file keeps, and every name in it
resolving to its files."""

import json
import re

import pytest

from portbench import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return mf.load_manifest()


def test_top_level_keys_and_size(man):
    assert set(man) == TOP
    assert mf.MANIFEST.stat().st_size <= 64 * 1024
    assert man["paths"] == ["portbench"]
    assert 1 <= len(man["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in man["command"])


def test_names_are_valid_and_unique(man):
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in man[kind]]
        assert len(names) == len(set(names)), kind
        assert all(NAME.match(n) for n in names), names
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for w in man["workloads"]:
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_entries_have_only_their_keys(man):
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and 1 <= len(m["layer"]) <= 200


def test_units_and_directions(man):
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_setup_bound_and_run_seconds_budget(man):
    setup = [m for m in man["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    r = man["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in mf.load_manifest()["workloads"]])
def test_each_cell_reports_what_it_must(man, cell):
    e2e = {m["name"] for m in mf.metrics(man, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = mf.metrics(man, cell, "per_layer")
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_per_layer_metrics_move_reported_metrics(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in man["workloads"]]):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in mf.load_manifest()["workloads"]])
def test_each_workload_resolves_to_its_files(man, cell):
    wl = mf.workload(man, cell)
    cfg, tr, spec = mf.cell_files(man, cell)
    assert (spec["config"], spec["traffic"]) == (wl["config"], wl["traffic"])
    assert cfg["name"] == wl["config"]
    assert tr["kind"] in ("request_pool", "training_jobs")
    drv = mf.driver(spec["driver"])
    assert hasattr(drv, "Session")
    for kind in ("end_to_end", "per_layer"):
        for m in mf.metrics(man, cell, kind):
            assert callable(mf.metric_reader(m["name"]).read)
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())


def test_every_cell_spec_names_its_files(man):
    for cell in mf.cells():
        cfg, tr, spec = mf.cell_files(man, cell)
        assert hasattr(mf.driver(spec["driver"]), "Session")
        assert cfg["name"] == spec["config"]


def test_config_files_are_distinct_and_reduce_no_width(man):
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    for c in man["configs"]:
        cfg = json.loads((mf.ROOT / c["file"]).read_text())
        for k in c["reduced"]:
            assert not re.search(r"(_dim|_rank|hidden|intermediate|inducing)", k), k
        assert cfg["dtype"] == "float32"


def test_files_are_named_from_names(man):
    ok = re.compile(r"^[A-Za-z0-9_./-]+$")
    for p in mf.HERE.rglob("*"):
        if "__pycache__" not in p.parts:
            assert ok.match(str(p.relative_to(mf.ROOT))), p
