"""BENCHMARK.json against the benchmark's contract: every cell resolves
to its files, names and units keep to their characters, every metric
has its reader, and every check a configuration makes has its limit."""
from __future__ import annotations

import re

import pytest

from portbench import harness
from portbench.tests.tiny import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
BENCH = harness.load_benchmark(REPO)


def test_top_level_keys_and_command():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_units_and_text():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    names = [e["name"] for e in entries]
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads"):
        ns = [e["name"] for e in BENCH[kind]]
        assert len(ns) == len(set(ns))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for e in BENCH["configs"] + BENCH["workloads"] + BENCH["per_layer"]:
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = harness.resolve(BENCH, cell, REPO)
    assert (c.base / "drivers" / f"{c.traffic['driver']}.py").is_file()
    assert (c.base / "generators" / f"{c.traffic['generator']}.py").is_file()
    assert (c.base / "builders" / f"{c.config['model_type']}.py").is_file()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert (c.base / "metrics" / f"{m['name']}.py").is_file()


def test_configs_files_and_limits():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        cfg = harness.load_json(REPO / c["file"])
        assert cfg["source"] == c["source"]
        assert sorted(cfg.get("reduced", [])) == sorted(c["reduced"])
        assert all(v >= 0 for v in cfg["limits"].values())


def test_per_layer_moves_a_reported_metric():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            target = e2e[m["moves"]]
            assert "workloads" not in target or cell in target["workloads"]
        layers.setdefault(m["layer"], []).append(m["name"])
    assert layers["device"] == ["idle_share.tpot", "idle_share.serve",
                                "idle_share.train"]
