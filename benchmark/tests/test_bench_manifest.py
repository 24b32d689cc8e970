"""BENCHMARK.json against the benchmark's contract, and the files it names.

Run from the repository root: ``python -m pytest benchmark/tests -q``.
"""

from __future__ import annotations

import json
import re
import shutil

import pytest

from benchmark import manifest

ROOT = manifest.ROOT
BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in cmd:
        if "/" in word:
            assert not word.startswith("/") and ".." not in word
            assert any(word.startswith(p + "/") for p in paths), word
            assert (ROOT / word).is_file()


def _entries(key):
    return BENCH[key]


@pytest.mark.parametrize("key,keys,optional", [
    ("configs", {"name", "source", "file", "reduced", "why"}, set()),
    ("workloads", {"name", "config", "traffic", "chips", "why"}, set()),
    ("end_to_end", {"name", "unit", "better", "bound", "source"},
     {"workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"},
     {"workloads"}),
])
def test_entry_keys(key, keys, optional):
    for e in _entries(key):
        assert keys <= set(e) <= keys | optional, e


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end",
                                 "per_layer"])
def test_names_units_and_lines(key):
    names = [e["name"] for e in _entries(key)]
    assert len(names) == len(set(names))
    for e in _entries(key):
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e and key in ("configs", "workloads", "per_layer"):
                assert _line(e[k]), (e["name"], k)


def test_counts_of_entries():
    assert 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_config_is_used_and_found():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        cfg = manifest.config(BENCH, c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_cell_is_found_by_name():
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        wl = manifest.workload(w["name"])
        assert wl["traffic"] == w["traffic"]
        assert hasattr(manifest.driver(wl["driver"]), "Driver")
        assert wl["limits"], w["name"]


def test_every_metric_is_found_by_name():
    for m in BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]))
        for cell in m.get("workloads", []):
            manifest.cell(BENCH, cell)


def test_end_to_end_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_rooflines_and_mfu_are_shares():
    for m in BENCH["per_layer"]:
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any(m["name"].split(".")[0] == "mfu" for m in BENCH["per_layer"])


def test_moves_names_a_metric_every_cell_of_it_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", [w["name"] for w in
                                        BENCH["workloads"]]):
            assert manifest.applies(target, cell), (m["name"], cell)

def test_layers_are_named_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert m["layer"] in perf, m["layer"]


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        names = {m["name"] for m in manifest.end_to_end(BENCH, w["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert manifest.per_layer(BENCH, w["name"])


def test_a_cell_and_a_metric_are_added_as_files_only(tmp_path):
    """A later change adds a cell and a metric by adding files and
    entries: the harness lists them without any edit."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "celeb256.serve_c8", "config": "celeb256",
        "traffic": "serve_c8", "chips": 1, "why": "a dummy cell"})
    bench["end_to_end"][0].setdefault("workloads", []).append(
        "celeb256.serve_c8")
    bench["end_to_end"][1].setdefault("workloads", []).append(
        "celeb256.serve_c8")
    bench["per_layer"].append({
        "name": "dummy_rows.serve", "unit": "img", "better": "higher",
        "source": "program_counter", "layer": "server/executor.py dispatcher",
        "moves": "edit_img_per_s", "workloads": ["celeb256.serve_c8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    wl = manifest.workload("celeb256.serve_c64")
    wl.update(traffic="serve_c8", clients=8)
    (root / "benchmark" / "workloads" / "celeb256.serve_c8.json").write_text(
        json.dumps(wl))
    (root / "benchmark" / "metrics" / "dummy_rows.serve.py").write_text(
        "def read(layers):\n    return layers.get('served')\n")

    loaded = manifest.load(root)
    assert manifest.cell(loaded, "celeb256.serve_c8")["traffic"] == "serve_c8"
    assert manifest.workload("celeb256.serve_c8", root)["clients"] == 8
    names = [m["name"] for m in manifest.per_layer(loaded,
                                                  "celeb256.serve_c8")]
    assert names == ["dummy_rows.serve"]
    read = manifest.reader("dummy_rows.serve", root)

    class Layers:
        def get(self, key, default=None):
            return {"served": 5}.get(key, default)
    assert read(Layers()) == 5
    assert "dummy_rows.serve" not in [
        m["name"] for m in manifest.per_layer(loaded, "celeb256.serve_c64")]
