#!/usr/bin/env python3
"""Where the time of one training step goes on the GPU, for the PyTorch port.

    python3 scripts/profile_torch_train.py [--batch 8] [--size 256]
        [--mode float32 tf32 bfloat16] [--reps 3] [--pack auto 0 1]

Runs the port's ``train_step`` (released flags: use_cam, pool max,
joint_train_inp; fresh seeded weights; a random batch; G and D flags 1)
under torch.profiler after warm-up and prints one JSON line per mode:
host wall ms per step, device kernel ms per step split into convolutions
(forward and both backward passes, cuDNN), the three attention kernels
(forward, dQ, dK/dV), the optimizer and everything else, the device's busy
share (kernel time over wall time), the kernel launches per step and the
ten kernels with the most device time, and the device ms of each spec row
of netM, netG and netD, forward (its conv and gating) and backward (the
autograd nodes its forward recorded; ``profile_rows_torch.py``). Modes:
float32 (TF32 off), tf32 (float32 with TF32 in convs and matmuls) and
bfloat16. ``--pack``: the packed fronts and tails as the policy decides
(auto), off (0) or on (1), through ``SKETCHEDIT_PACK``. Needs a GPU.
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import train_batch  # noqa: E402
from profile_rows_torch import (  # noqa: E402
    RowRanges, category, kernel_times, row_times)
from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig  # noqa: E402
from sketchedit_tpu_torch.ops.packed_tail import use_packing  # noqa: E402
from sketchedit_tpu_torch.runner import set_precision  # noqa: E402
from sketchedit_tpu_torch.train import trainer as tr  # noqa: E402

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--mode", nargs="+", default=["float32", "tf32",
                                                  "bfloat16"],
                    choices=["float32", "tf32", "bfloat16"])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--pack", nargs="+", default=["auto"],
                    choices=["auto", "0", "1"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    batch = tr.batch_to_device(train_batch(args.batch, args.size, 0), "cuda")
    for pack in args.pack:
        if pack == "auto":
            os.environ.pop("SKETCHEDIT_PACK", None)
        else:
            os.environ["SKETCHEDIT_PACK"] = pack
        for mode in args.mode:
            profile_one(batch, mode, pack, args, card)


def profile_one(batch, mode, pack, args, card):
    cfg = tr.TrainConfig(
        netg=DeepFillConfig(attention_impl="auto"),
        compute_dtype="bfloat16" if mode == "bfloat16" else "float32",
        precision=None if mode == "tf32" else "highest")
    set_precision(cfg.precision)
    state = tr.init_train_state(cfg, seed=0, device="cuda")
    for _ in range(2):
        tr.train_step(state, batch, 1, 1, cfg)
    torch.cuda.synchronize()
    with RowRanges(state.nets), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            tr.train_step(state, batch, 1, 1, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.reps
    events = prof.events()
    kernels, launches = kernel_times(events, args.reps)
    by_cat: dict[str, float] = {}
    for name, ms in kernels:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms
    fwd, bwd = row_times(events, args.reps)
    rows = {r: [fwd.get(r, 0.0), bwd.get(r, 0.0)] for r in {*fwd, *bwd}}
    device_ms = sum(by_cat.values())
    print(json.dumps({
        "mode": mode, "batch": args.batch, "hw": [args.size] * 2,
        "card": card, "pack": pack,
        "packed": use_packing(args.batch, getattr(torch, cfg.compute_dtype),
                              training=True),
        "wall_ms_per_step": wall,
        "img_per_s": args.batch * 1e3 / wall,
        "device_ms_per_step": device_ms,
        "device_busy_share": device_ms / wall,
        "device_ms_by_category": by_cat,
        "kernel_launches_per_step": launches,
        "top_kernels_ms": [(n[:90], ms) for n, ms in kernels[:10]],
        "rows_fwd_bwd_ms": dict(sorted(rows.items(),
                                       key=lambda kv: -sum(kv[1]))),
        "rows_total_ms": [sum(fwd.values()), sum(bwd.values())],
    }), flush=True)


if __name__ == "__main__":
    main()
