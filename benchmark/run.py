#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``sketchedit_tpu_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell's configuration and traffic (``BENCHMARK.json`` and the
files ``manifest.py`` finds), sets the program up and warms every shape
the traffic uses, measures for ``--seconds``, then holds what the timed
path produced to the plain reference (``reference/``). The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics, read from a profiled slice of the
window), ``device``, ``setup_split`` and ``host`` (the set-up's phases and the
CPUs over the window, ``host.py``; neither is compared) and, last,
``checks``: each number compared beside its limit, which are also the
last lines of standard error.

PyTorch's CPU operators run on one thread (the program's CPU work is
copies; the default's idle threads spin on a second core). Needs an
NVIDIA GPU: without one it exits 2 and prints no result. It
exits 3 and prints no result if JAX, Flax or the JAX package is loaded by
the end of the run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path

_HERE = Path(__file__).resolve().parent
ROOT = _HERE.parent
if __name__ == "__main__":
    # run as a script: import the benchmark and the program from the
    # checkout, not the benchmark's own folder
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != _HERE]
    sys.path.insert(0, str(ROOT))
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
    os.environ["USE_FLAX"] = "0"

from benchmark import host  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sketchedit_tpu")


def _started() -> float:
    """Seconds since boot at which this process started (CLOCK_BOOTTIME),
    from /proc; the time of this module's import where /proc says
    nothing."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        return int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return host.now()


START = _started()

import torch  # noqa: E402

from benchmark import counts, manifest  # noqa: E402
from benchmark.layers import Layers  # noqa: E402
from benchmark.trace import Tracer  # noqa: E402


@dataclass
class Cell:
    name: str
    config: dict
    workload: dict
    seed: int
    device: torch.device
    program: str = "port"        # "control": the reference in float8
    fault: str | None = None     # a planted fault (tests, calibration)
    phases: host.Phases = field(default_factory=lambda: host.Phases(START))


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card() -> dict:
    name = torch.cuda.get_device_name(0)
    out = {"platform": "gpu", "kind": name, "count": 1}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        out["power_limit_w"] = float(smi.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        pass
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", root: Path = ROOT, config_overrides=None,
             workload_overrides=None, program="port", fault=None):
    """One run; returns the result object the command prints."""
    bench = manifest.load(root)
    entry = manifest.cell(bench, name)
    config = {**manifest.config(bench, entry["config"], root),
              **(config_overrides or {})}
    workload = {**manifest.workload(name, root), **(workload_overrides or {})}
    device = torch.device(device)
    cuda = device.type == "cuda"
    cell = Cell(name, config, workload, seed, device, program, fault)
    phases = cell.phases
    phases.mark("start")
    drv = manifest.driver(workload["driver"]).Driver(cell)
    tracer = Tracer() if trace else None
    if cuda:
        torch.cuda.init()
        torch.empty(1, device=device)
        phases.mark("cuda_init")
        if tracer is not None:
            tracer.warm()
            phases.mark("tracer")
        torch.cuda.reset_peak_memory_stats()
    drv.setup(tracer)
    setup_s = host.now() - START
    before = host.snapshot()
    win = drv.window(seconds)
    cpus = host.over(before, host.snapshot())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = (tracer.read() if tracer is not None
              and tracer.prof is not None else None)
    drv.release()
    numbers = drv.check()

    limits = workload["limits"]
    checks = {k: {"value": numbers.get(k), "limit": limits[k]}
              for k in limits}
    correct = win["failed"] == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())

    metrics = {}
    if trace:
        peaks = counts.peaks(torch.cuda.get_device_name(0) if cuda else "")
        layers = Layers(win["layers"], traced, config, peaks)
        for m in manifest.per_layer(bench, name):
            value = manifest.reader(m["name"], root)(layers)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **win["e2e"]}
        for m in manifest.end_to_end(bench, name):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    dev = card() if cuda else {"platform": "cpu", "kind": "cpu", "count": 1}
    dev["memory_peak_bytes"] = peak
    result = {"correct": correct, "attempted": win["attempted"],
              "failed": win["failed"], "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"], dev["window_s"] = traced.busy_s, traced.window_s
        result["breakdown"] = {"device_ops": traced.device_ops,
                               "idle_gaps": traced.idle_gaps}
    result["setup_split"] = phases.split
    result["host"] = {**cpus, **win.get("host", {})}
    result["checks"] = checks
    result["numbers"] = numbers       # all the check's readings
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    entry = manifest.cell(manifest.load(), args.workload)
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; this benchmark runs on the GPU "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"benchmark: {args.workload} needs {entry['chips']} GPUs, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    # the program's CPU work is copies: one thread for PyTorch's CPU
    # operators, so that the process loads the host little
    torch.set_num_threads(1)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    print("numbers " + json.dumps(result.pop("numbers")), file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
