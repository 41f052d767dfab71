"""Finds a cell's pieces by name: ``workloads/<name>.json``,
``configs/<name>.json``, ``traffic/<kind>.py``, ``metrics/<name>.py``, and
the metric lists of ``BENCHMARK.json`` at the checkout's root."""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List, Tuple

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
    if not NAME.match(name) or ".." in name:
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def _json(folder: str, name: str) -> dict:
    path = HERE / folder / f"{_name(name)}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r} ({path.name} in {folder}/)")
    return json.loads(path.read_text())


def workload(name: str) -> dict:
    return _json("workloads", name)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(kind: str) -> ModuleType:
    if not re.match(r"^[a-z_][a-z0-9_]*$", kind) or not (HERE / "traffic" / f"{kind}.py").is_file():
        raise FileNotFoundError(f"no traffic kind {kind!r} (traffic/{kind}.py)")
    return importlib.import_module(f"hsi_bench.traffic.{kind}")


def metric(name: str) -> ModuleType:
    """The reader of metric ``name`` (``metrics/<name>.py``, loaded by path:
    metric names hold dots)."""
    path = HERE / "metrics" / f"{_name(name)}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} (metrics/{name}.py)")
    spec = importlib.util.spec_from_file_location(f"hsi_bench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def benchmark(path: Path = BENCHMARK) -> dict:
    return json.loads(Path(path).read_text())


def metrics_for(bench: dict, cell: str, traced: bool) -> List[Tuple[str, str]]:
    """(name, unit) of the metrics a run of ``cell`` reports: the end-to-end
    ones untraced, the per-layer ones traced; a metric with a
    ``workloads`` list only in those cells."""
    section = bench["per_layer"] if traced else bench["end_to_end"]
    return [(m["name"], m["unit"]) for m in section
            if "workloads" not in m or cell in m["workloads"]]
