#!/usr/bin/env python3
"""Where the time of one edit goes on the GPU, for the PyTorch port.

    python3 scripts/profile_torch_edit.py [--batch 1 4] [--dtype float32]
        [--pack auto 0 1]

Runs the port's EditPipeline (released flags, fresh seeded weights, 256^2
uint8 inputs) under torch.profiler after warm-up and prints one JSON line
per (pack, dtype, batch): host wall ms per call, device kernel ms per call
split into convolutions (cuDNN's FFT kernels among them), the attention
kernel and everything else, the device's busy share (kernel time over wall
time), the number of kernel launches per call, the ten kernels with the
most device time, and the device ms of each spec row of netM and netG (its
conv and gating; a packed group of rows as one, ``profile_rows_torch.py``).
``--pack``: the packed fronts and tails as the policy decides (auto), off
(0) or on (1), through ``SKETCHEDIT_PACK``. Needs a GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from profile_rows_torch import (  # noqa: E402
    RowRanges, category, kernel_times, row_times)
from sketchedit_tpu_torch.options import parse_argv  # noqa: E402
from sketchedit_tpu_torch.options.test_options import TestOptions  # noqa: E402
from sketchedit_tpu_torch.ops.packed_tail import use_packing  # noqa: E402
from sketchedit_tpu_torch.runner import build_pipeline  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--dtype", nargs="+", default=["float32"])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--pack", nargs="+", default=["auto"],
                    choices=["auto", "0", "1"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_edit: needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    tmp = tempfile.TemporaryDirectory(prefix="profile_ck_")   # removed at exit
    ckdir = tmp.name
    for pack in args.pack:
        if pack == "auto":
            os.environ.pop("SKETCHEDIT_PACK", None)
        else:
            os.environ["SKETCHEDIT_PACK"] = pack
        for dtype in args.dtype:
            with contextlib.redirect_stdout(io.StringIO()):
                opt = parse_argv(TestOptions, [
                    "--name", "celeb", "--checkpoints_dir", ckdir,
                    "--use_cam", "--pool_type", "max", "--joint_train_inp",
                    "--init_type", "kaiming", "--compute_dtype", dtype])
                pipe = build_pipeline(opt)
            nets = {"M": pipe.model.netM, "G": pipe.model.netG}
            for B in args.batch:
                profile_one(pipe, nets, B, dtype, pack, args.reps, card)


def profile_one(pipe, nets, B, dtype, pack, reps, card):
    rs = np.random.RandomState(B)
    img = rs.randint(0, 256, (B, 256, 256, 3)).astype(np.uint8)
    sk = ((rs.rand(B, 256, 256, 1) > 0.92) * 255).astype(np.uint8)
    for _ in range(3):
        pipe(img, sk)
    torch.cuda.synchronize()
    with RowRanges(nets), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            pipe(img, sk)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    events = prof.events()
    kernels, launches = kernel_times(events, reps)
    by_cat: dict[str, float] = {}
    for name, ms in kernels:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms
    rows, _ = row_times(events, reps)
    device_ms = sum(by_cat.values())
    print(json.dumps({
        "batch": B, "dtype": dtype, "hw": [256, 256], "card": card,
        "pack": pack, "packed": use_packing(B, getattr(torch, dtype)),
        "wall_ms_per_call": wall, "device_ms_per_call": device_ms,
        "device_busy_share": device_ms / wall,
        "device_ms_by_category": by_cat,
        "kernel_launches_per_call": launches,
        "top_kernels_ms": [(n[:90], ms) for n, ms in kernels[:10]],
        "rows_ms": dict(sorted(rows.items(), key=lambda kv: -kv[1])),
        "rows_total_ms": sum(rows.values()),
    }), flush=True)


if __name__ == "__main__":
    main()
