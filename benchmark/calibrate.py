#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the GPU.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--seconds 4] [--control-seeds 3] [--fault-seeds 3] [--out FILE] \
        [--set KEY=JSON ...]

In one process, for each seed: the program's run of the cell (set-up, a
short window at the cell's own load, the check) gives the program's
numbers (the lower readings); on the first ``--control-seeds`` seeds the
control, the reference in float8 put in the program's place on the same
inputs (the sampled requests, or the first three training
steps), gives its numbers (the upper readings); in a training cell, on
the first ``--fault-seeds`` seeds, the program with half of each batch
left out gives the fault's. One JSON line per reading (in training with
each leaf's first gradient and change for the program, the reference and
plain bfloat16); with ``--out`` also appended to that file.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path
                   if Path(p or ".").resolve() != _HERE]
    sys.path.insert(0, str(_HERE.parent))

import torch  # noqa: E402

from benchmark import manifest, run, weights  # noqa: E402
from benchmark.reference import edit as ref_edit  # noqa: E402
from benchmark.reference.precision import BF16, FP8  # noqa: E402
from benchmark.traffic import serve_closed, train_steps  # noqa: E402


def _plain(obj):
    """Tensors (masks) left out of a JSON line."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()
                if not isinstance(v, torch.Tensor) and k != "hard"}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def emit(obj, out):
    line = json.dumps(_plain(obj))
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def free():
    gc.collect()
    torch.cuda.empty_cache()


def serve_control(drv, q) -> dict:
    """The control's numbers on the requests the program's check drew."""
    W = {n: weights.make(n, drv.cell.seed, drv.dev, drv.cfg["gains"])
         for n in "MG"}
    samples = []
    block = drv.wl["check_block"]
    idxs = [s[0] for s in drv.samples]
    for i in range(0, len(idxs), block):
        part = idxs[i:i + block]
        comp, mask, hard = ref_edit.edit(
            W, torch.from_numpy(drv.images[part]).to(drv.dev),
            torch.from_numpy(drv.sketches[part]).to(drv.dev), q)
        for j, idx in enumerate(part):
            samples.append((idx, comp[j].cpu().numpy(),
                            mask[j].cpu().numpy(), hard[j]))
    return serve_closed.judge(W, drv.images, drv.sketches, samples, drv.dev,
                              block)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--set", nargs="*", default=[], metavar="KEY=JSON",
                    help="override configuration keys (a look at another "
                         "precision, say compute_dtype=\"float32\")")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a GPU", file=sys.stderr)
        return 2
    bench = manifest.load()
    entry = manifest.cell(bench, args.workload)
    config = manifest.config(bench, entry["config"])
    for item in args.set:
        key, value = item.split("=", 1)
        config[key] = json.loads(value)
    workload = manifest.workload(args.workload)
    threshold = config["mask_threshold"]
    dev = torch.device("cuda")
    for i, seed in enumerate(args.seeds):
        cell = run.Cell(args.workload, config, workload, seed, dev)
        drv = manifest.driver(workload["driver"]).Driver(cell)
        t0 = time.perf_counter()
        drv.setup()
        win = drv.window(args.seconds)
        drv.release()
        train = workload["driver"] == "train_steps"
        if train:
            ref = drv.reference(hard=drv.first["hard"])
            low = drv.reference(BF16, hard=drv.first["hard"])
            numbers = train_steps.judge(drv.first, ref, low, threshold)
        else:
            numbers = drv.check()
        row = {"workload": args.workload, "seed": seed, "side": "program",
               "numbers": numbers, "failed": win["failed"],
               "attempted": win["attempted"], "e2e": win["e2e"],
               "seconds": time.perf_counter() - t0}
        if train:
            row["first"], row["reference"], row["bf16"] = drv.first, ref, low
        emit(row, args.out)
        if i < args.control_seeds:
            row = {"workload": args.workload, "seed": seed,
                   "side": "control_fp8_e4m3"}
            if train:
                ctl = drv.reference(FP8)
                ctl["threshold_mismatch_px"] = 0
                row["numbers"] = train_steps.judge(
                    ctl, drv.reference(hard=ctl["hard"]),
                    drv.reference(BF16, hard=ctl["hard"]), threshold)
                row["first"] = ctl
            else:
                row["numbers"] = serve_control(drv, FP8)
            emit(row, args.out)
        del drv
        free()
        if train and i < args.fault_seeds:
            cell = run.Cell(args.workload, config, workload, seed, dev,
                            fault="half_batch")
            drv = train_steps.Driver(cell)
            drv.setup()
            drv.release()
            emit({"workload": args.workload, "seed": seed,
                  "side": "fault_half_batch", "first": drv.first,
                  "numbers": train_steps.judge(drv.first, ref, low,
                                               threshold)},
                 args.out)
            del drv
            free()
    bad = run.forbidden_modules()
    if bad:
        print(f"calibrate: JAX modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
