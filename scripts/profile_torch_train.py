#!/usr/bin/env python3
"""Where the time of one training step goes on the GPU, for the PyTorch port.

    python3 scripts/profile_torch_train.py [--batch 8] [--size 256]
        [--mode float32 tf32 bfloat16] [--reps 3]

Runs the port's ``train_step`` (released flags: use_cam, pool max,
joint_train_inp; fresh seeded weights; a random batch; G and D flags 1)
under torch.profiler after warm-up and prints one JSON line per mode:
host wall ms per step, device kernel ms per step split into convolutions
(forward and both backward passes, cuDNN), the three attention kernels
(forward, dQ, dK/dV), the optimizer and everything else, the device's busy
share (kernel time over wall time), the kernel launches per step and the
ten kernels with the most device time. Modes: float32 (TF32 off), tf32
(float32 with TF32 in convs and matmuls) and bfloat16. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import train_batch  # noqa: E402
from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig  # noqa: E402
from sketchedit_tpu_torch.runner import set_precision  # noqa: E402
from sketchedit_tpu_torch.train import trainer as tr  # noqa: E402

CATEGORIES = ("conv", "attention_fwd", "attention_dq", "attention_dkdv",
              "optimizer", "other")


def category(name: str) -> str:
    low = name.lower()
    for kernel, cat in (("ca_fwd_kernel", "attention_fwd"),
                        ("ca_dq_kernel", "attention_dq"),
                        ("ca_dkdv_kernel", "attention_dkdv")):
        if kernel in low:
            return cat
    if "multi_tensor" in low or "adam" in low:
        return "optimizer"
    # cuDNN's kernels, the FFT convolutions among them
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "winograd",
                              "fprop", "dgrad", "wgrad", "gemm", "sm90",
                              "fft", "complex")):
        return "conv"
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--mode", nargs="+", default=["float32", "tf32",
                                                  "bfloat16"],
                    choices=["float32", "tf32", "bfloat16"])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    batch = tr.batch_to_device(train_batch(args.batch, args.size, 0), "cuda")
    for mode in args.mode:
        cfg = tr.TrainConfig(
            netg=DeepFillConfig(attention_impl="auto"),
            compute_dtype="bfloat16" if mode == "bfloat16" else "float32",
            precision=None if mode == "tf32" else "highest")
        set_precision(cfg.precision)
        state = tr.init_train_state(cfg, seed=0, device="cuda")
        for _ in range(2):
            tr.train_step(state, batch, 1, 1, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                tr.train_step(state, batch, 1, 1, cfg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / args.reps
        by_cat = dict.fromkeys(CATEGORIES, 0.0)
        top: dict[str, float] = {}
        launches = 0
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                ms = evt.time_range.elapsed_us() / 1e3 / args.reps
                by_cat[category(evt.name)] += ms
                top[evt.name[:90]] = top.get(evt.name[:90], 0.0) + ms
                launches += 1
        device_ms = sum(by_cat.values())
        print(json.dumps({
            "mode": mode, "batch": args.batch, "hw": [args.size] * 2,
            "card": card, "wall_ms_per_step": wall,
            "img_per_s": args.batch * 1e3 / wall,
            "device_ms_per_step": device_ms,
            "device_busy_share": device_ms / wall,
            "device_ms_by_category": by_cat,
            "kernel_launches_per_step": launches / args.reps,
            "top_kernels_ms": sorted(top.items(), key=lambda kv: -kv[1])[:10],
        }), flush=True)


if __name__ == "__main__":
    main()
