"""BENCHMARK.json: names, units and the files found by name."""

import json
import re

import pytest

from benchmark import manifest

MAN = manifest.load_manifest()
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_top_level_keys():
    assert set(MAN) == TOP_KEYS
    assert MAN["command"] == ["python3", "-m", "benchmark.run"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51


def _names():
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in MAN[k]:
            yield e["name"]
    for w in MAN["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in MAN["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_allowed_characters(name):
    assert NAME_RE.match(name), name


def test_names_are_unique():
    for k in ("configs", "workloads"):
        names = [e["name"] for e in MAN[k]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_fields():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert "\n" not in m["layer"] and "\t" not in m["layer"]
        assert 1 <= len(m["layer"]) <= 200
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        cells = {w["name"] for w in MAN["workloads"]}
        assert set(m.get("workloads", ())) <= cells


def test_every_cell_reports_enough():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in manifest.metrics_for(MAN, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_for(MAN, w["name"], True)
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    w = manifest.cell(MAN, cell)
    cfg = json.loads(manifest.config_path(w["config"]).read_text())
    json.loads(manifest.traffic_path(w["traffic"]).read_text())
    entry = [c for c in MAN["configs"] if c["name"] == w["config"]][0]
    assert entry["file"] == f"benchmark/configs/{w['config']}.json"
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    for m in manifest.metrics_for(MAN, cell, False) + \
            manifest.metrics_for(MAN, cell, True):
        assert callable(manifest.reader(m["name"]))


def test_configs_state_their_guarantees():
    for c in MAN["configs"]:
        cfg = json.loads((manifest.ROOT / c["file"]).read_text())
        assert cfg["guarantees"]["qos"] == 1
        assert {"ack", "delivery", "shared", "loss"} <= set(cfg["guarantees"])
        assert isinstance(cfg["assumed"], list)
        assert len(c["source"]) <= 200


def test_file_size():
    assert len((manifest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
