#!/usr/bin/env python3
"""Where the time of one edit goes on the GPU, for the PyTorch port.

    python3 scripts/profile_torch_edit.py [--batch 1 4] [--dtype float32]

Runs the port's EditPipeline (released flags, fresh seeded weights, 256^2
uint8 inputs) under torch.profiler after warm-up and prints one JSON line
per (batch, dtype): host wall ms per call, device kernel ms per call split
into convolutions, the attention kernel and everything else, the device's
busy share (kernel time over wall time), the number of kernel launches per
call, and the ten kernels with the most device time. Needs a GPU.
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

from sketchedit_tpu_torch.options import parse_argv  # noqa: E402
from sketchedit_tpu_torch.options.test_options import TestOptions  # noqa: E402
from sketchedit_tpu_torch.runner import build_pipeline  # noqa: E402


def category(name: str) -> str:
    low = name.lower()
    if "ca_fwd_kernel" in low:
        return "attention_kernel"
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "winograd",
                              "fprop", "gemm", "sm90")):
        return "conv"
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--dtype", nargs="+", default=["float32"])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_edit: needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    tmp = tempfile.TemporaryDirectory(prefix="profile_ck_")   # removed at exit
    ckdir = tmp.name
    for dtype in args.dtype:
        with contextlib.redirect_stdout(io.StringIO()):
            opt = parse_argv(TestOptions, [
                "--name", "celeb", "--checkpoints_dir", ckdir, "--use_cam",
                "--pool_type", "max", "--joint_train_inp", "--init_type",
                "kaiming", "--compute_dtype", dtype])
            pipe = build_pipeline(opt)
        for B in args.batch:
            rs = np.random.RandomState(B)
            img = rs.randint(0, 256, (B, 256, 256, 3)).astype(np.uint8)
            sk = ((rs.rand(B, 256, 256, 1) > 0.92) * 255).astype(np.uint8)
            for _ in range(3):
                pipe(img, sk)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    pipe(img, sk)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / args.reps
            by_cat = {"conv": 0.0, "attention_kernel": 0.0, "other": 0.0}
            kernels, launches = [], 0
            for evt in prof.events():
                if evt.device_type == torch.autograd.DeviceType.CUDA:
                    us = evt.time_range.elapsed_us()
                    by_cat[category(evt.name)] += us / 1e3 / args.reps
                    launches += 1
                    kernels.append((evt.name, us))
            top: dict[str, float] = {}
            for name, us in kernels:
                top[name[:90]] = top.get(name[:90], 0.0) + us / 1e3 / args.reps
            device_ms = sum(by_cat.values())
            print(json.dumps({
                "batch": B, "dtype": dtype, "hw": [256, 256], "card": card,
                "wall_ms_per_call": wall, "device_ms_per_call": device_ms,
                "device_busy_share": device_ms / wall,
                "device_ms_by_category": by_cat,
                "kernel_launches_per_call": launches / args.reps,
                "top_kernels_ms": sorted(top.items(), key=lambda kv: -kv[1])[:10],
            }), flush=True)


if __name__ == "__main__":
    main()
