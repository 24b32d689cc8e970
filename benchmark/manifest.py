"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a cell: ``workloads/<cell>.json``, its traffic mix's parameters, its
  correctness limits and the ``driver`` that runs it;
- a traffic driver: ``traffic/<driver>.py``, a module with a ``Driver``;
- a per-layer metric: ``metrics/<metric>.py``, a module with ``read``.

Adding a configuration, a cell or a metric adds files and entries; no
file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def workload_file(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "workloads" / f"{name}.json"


def workload(name: str, root: Path = ROOT) -> dict:
    return json.loads(workload_file(name, root).read_text())


def driver(kind: str):
    return importlib.import_module(f"benchmark.traffic.{kind}")


def applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list:
    return [m for m in bench["end_to_end"] if applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list:
    return [m for m in bench["per_layer"] if applies(m, cell_name)]


def metric_file(name: str, root: Path = ROOT) -> Path:
    return root / "benchmark" / "metrics" / f"{name}.py"


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``metrics/<name>.py`` (names hold dots, so
    the file is loaded by path)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), metric_file(name, root))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
