#!/usr/bin/env python3
"""Runs of one cell in sets, and each metric's spread, on the GPU.

    python3 benchmark/spread.py --workload <cell> --seeds 1 2 3 4 5 6 \
        [--sets 2] [--seconds S] [--trace 0] [--out FILE]

Each set runs ``benchmark/run.py`` once per seed, one process at a time
(the seeds in the same order in every set). Prints one JSON line per run
(its result line, with every reading of its check under ``numbers``)
and then a summary: per set and metric the median, the
quartiles from ``statistics.quantiles(values, n=4)`` and the spread (third
quartile minus first over the median), and the runs whose ``correct`` was
false. ``--seconds`` defaults to ``run_seconds`` of ``BENCHMARK.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def summary(values):
    if len(values) < 2:
        return {"values": values}
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"median": statistics.median(values), "q1": q1, "q3": q3,
            "spread": (q3 - q1) / statistics.median(values),
            "values": values}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seconds = args.seconds or json.loads(
        (ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    sets, wrong = [], []
    for s in range(args.sets):
        runs = []
        for seed in args.seeds:
            cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"),
                   "--workload", args.workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(args.trace)]
            out = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                 text=True)
            line = (out.stdout.strip().splitlines() or [""])[-1]
            try:
                result = json.loads(line)
            except json.JSONDecodeError:
                result = {"rc": out.returncode,
                          "stderr": out.stderr[-3000:]}
            for err in out.stderr.splitlines():
                if err.startswith("numbers "):    # every check reading
                    result["numbers"] = json.loads(err[len("numbers "):])
            result.update(set=s, seed=seed)
            print(json.dumps(result), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(result) + "\n")
            if not result.get("correct"):
                wrong.append((s, seed))
            runs.append(result)
        sets.append(runs)
    report = {"workload": args.workload, "seconds": seconds,
              "wrong": wrong, "sets": []}
    for runs in sets:
        names = sorted({k for r in runs for k in r.get("metrics", {})})
        report["sets"].append({
            n: summary([r["metrics"][n]["value"] for r in runs
                        if n in r.get("metrics", {})])
            for n in names})
    print(json.dumps(report), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(report) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
