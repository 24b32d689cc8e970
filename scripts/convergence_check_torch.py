"""Training-stack convergence check on the PyTorch port (counterpart of
``scripts/convergence_check.py``: the same batch, defaults, printout and
pass rule).

Overfits the full G+D step on one fixed batch and requires the L1 terms to
drop well below their first values: evidence that the whole stack (mixed
precision, the attention kernels forward and backward, TTUR, the
spectral-norm discriminator) learns over hundreds of steps, beyond the
single-step checks.

    python scripts/convergence_check_torch.py [--steps 450] [--size 128]
        [--dtype bfloat16|float32] [--attention_impl kernel|dense]
        [--precision default|highest] [--device cuda|cpu]

The batch is the JAX script's: numpy RandomState(0), image = gt uniform in
[-1, 1], mask and edgegt > 0.95, random_mask and random_mask2 > 0.7. The
JAX step draws its branch flags from a key; here they come from the
state's seeded generator (``train/trainer.py::draw_flags``). The script
prints the losses at step 0, every 50th step and the last, then a
CONVERGES or FAILED line (final L1c and L1f both below --ratio times their
first values), and last one JSON line: converges, steps, first and last
losses, seconds, ms per step, dtype, attention route, the kernels'
launches and the card's name and power limit. Exit code 0 only on
CONVERGES. ``--precision highest`` turns TF32 off (the float32 reference
setting).
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOSSES = ("G_total", "L1c", "L1f", "D_Fake", "D_real")
COUNTERS = ("LAUNCHES", "LAUNCHES_LSE", "LAUNCHES_SHARED", "LAUNCHES_DSPLIT",
            "LAUNCHES_DQ", "LAUNCHES_DKDV", "LAUNCHES_BWD", "LAUNCHES_DV",
            "LAUNCHES_DK")


def card(device) -> str | None:
    """``nvidia-smi``'s name and power limit of the card, or None on the
    CPU."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=450)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--attention_impl", default="kernel",
                    choices=("kernel", "dense"))
    ap.add_argument("--precision", default="default",
                    choices=("default", "highest"))
    ap.add_argument("--ratio", type=float, default=0.7,
                    help="final L1 must be below ratio * initial")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--flag_seed", type=int, default=1,
                    help="the branch flags' generator (the JAX script's "
                         "step keys come from PRNGKey(1))")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sketchedit_tpu_torch.device import resolve_device, set_precision
    from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
    from sketchedit_tpu_torch.ops import attention_cuda
    from sketchedit_tpu_torch.train.trainer import (
        TrainConfig, batch_to_device, draw_flags, init_train_state,
        train_step)

    device = resolve_device(args.device)
    precision = None if args.precision == "default" else "highest"
    set_precision(precision)
    cfg = TrainConfig(netg=DeepFillConfig(attention_impl=args.attention_impl),
                      compute_dtype=args.dtype, lr=args.lr,
                      precision=precision)
    state = init_train_state(cfg, seed=0, flag_seed=args.flag_seed,
                             device=device)
    rs = np.random.RandomState(0)
    B, S = args.batch, args.size
    img = rs.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    batch = batch_to_device({
        "image": img, "gt": img,
        "mask": (rs.rand(B, S, S, 1) > 0.95).astype(np.float32),
        "edgegt": (rs.rand(B, S, S, 1) > 0.95).astype(np.float32),
        "random_mask": (rs.rand(B, S, S, 1) > 0.7).astype(np.float32),
        "random_mask2": (rs.rand(B, S, S, 1) > 0.7).astype(np.float32),
    }, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    before = {k: getattr(attention_cuda, k) for k in COUNTERS}
    first = vals = None
    t0 = time.perf_counter()
    for i in range(args.steps):
        flag_g, flag_d = draw_flags(state, cfg)
        state, m = train_step(state, batch, flag_g, flag_d, cfg)
        if i == 0 or i % 50 == 0 or i == args.steps - 1:
            vals = {k: round(float(v), 4) for k, v in m.items()
                    if k in LOSSES}
            print(i, vals, flush=True)
            first = first or vals
        if i == 0:      # the first step builds the kernels and picks convs
            sync()
            t1 = time.perf_counter()
    sync()
    t2 = time.perf_counter()
    seconds = t2 - t0
    last = vals
    ok = (last["L1c"] < first["L1c"] * args.ratio
          and last["L1f"] < first["L1f"] * args.ratio)
    print(f"{'CONVERGES' if ok else 'FAILED'}: "
          f"L1c {first['L1c']:.3f} -> {last['L1c']:.3f}, "
          f"L1f {first['L1f']:.3f} -> {last['L1f']:.3f}")
    print(json.dumps({
        "converges": ok, "steps": args.steps, "first": first, "last": last,
        "ratios": {k: last[k] / first[k] for k in ("L1c", "L1f")},
        "seconds": seconds,
        # steady state: the steps after the first
        "ms_per_step": ((t2 - t1) / (args.steps - 1) * 1e3
                        if args.steps > 1 else None),
        "dtype": args.dtype, "attention_impl": args.attention_impl,
        "precision": args.precision, "size": S, "batch": B,
        "flag_seed": args.flag_seed,
        "launches": {k: getattr(attention_cuda, k) - before[k]
                     for k in COUNTERS},
        "device": str(device), "card": card(device)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
