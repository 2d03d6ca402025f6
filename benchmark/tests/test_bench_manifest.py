"""BENCHMARK.json against the contract's character rules, and every cell's
files found by name."""
import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
LINE = re.compile(r"[^\t\n]{1,200}")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert ".." not in p.split("/") and not p.startswith("/")


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.fullmatch(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.fullmatch(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert LINE.fullmatch(entry[key])
    if "unit" in entry:
        assert UNIT.fullmatch(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for k in entry.get("reduced", []):
        assert NAME.fullmatch(k)


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_metric_entries():
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_resolve_by_name(cell):
    loaded = harness.load_cell(cell["name"])
    wl = json.load(open(os.path.join(ROOT, "benchmark", "workloads",
                                     cell["name"] + ".json")))
    assert wl["config"] == cell["config"] and wl["traffic"] == cell["traffic"]
    assert wl["chips"] == cell["chips"]
    assert loaded["workload"]["traffic"]["name"] == cell["traffic"]
    cfg = [c for c in BENCH["configs"] if c["name"] == cell["config"]][0]
    assert cfg["file"] == f"benchmark/configs/{cell['config']}.json"
    assert loaded["config"]["reduced"] == cfg["reduced"]
    assert os.path.isfile(os.path.join(
        ROOT, "benchmark", "entries", loaded["config"]["entry"] + ".py"))
    names = {m["name"] for m in loaded["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert loaded["per_layer"]
    for m in loaded["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
        assert callable(harness.load_reader(m["name"]))


def test_every_config_is_used_and_reduced_keys_are_in_its_file():
    used = {c["config"] for c in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        data = json.load(open(os.path.join(ROOT, c["file"])))
        for k in c["reduced"]:
            assert k in data
