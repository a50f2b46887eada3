"""``BENCHMARK.json`` and the files it names.

A cell names a configuration and a traffic mix; the harness finds
``benchmark/configs/<config>.json``, ``benchmark/traffic/<traffic>.json``
and, for every metric, ``benchmark/metrics/<metric>.py`` by those names
alone. A metric whose entry has ``workloads`` is read in those cells; an
end-to-end metric without it in every cell; a per-layer metric without
it in every cell that reports the end-to-end metric it ``moves``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def applies(metric: dict, cell_name: str, reported: List[str]) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def metrics_for(man: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of ``cell_name`` prints: the end-to-end ones
    with ``trace`` off, the per-layer ones with it on."""
    e2e = [m for m in man["end_to_end"] if applies(m, cell_name, [])]
    if not trace:
        return e2e
    names = [m["name"] for m in e2e]
    return [m for m in man["per_layer"] if applies(m, cell_name, names)]


def config_path(name: str) -> Path:
    return _file(HERE / "configs" / f"{name}.json")


def traffic_path(name: str) -> Path:
    return _file(HERE / "traffic" / f"{name}.json")


def metric_path(name: str) -> Path:
    return _file(HERE / "metrics" / f"{name}.py")


def _file(p: Path) -> Path:
    if not p.is_file():
        raise FileNotFoundError(f"no such file: {p}")
    return p


def reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    p = metric_path(name)
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(metrics: List[dict]) -> Dict[str, object]:
    return {m["name"]: reader(m["name"]) for m in metrics}
