#!/usr/bin/env python3
"""Packed against plain fronts and tails of the port on the GPU, in turns.

    python3 scripts/packing_ab_torch.py [--batch 1 4 8 32 64]
        [--dtype float32 tf32 bfloat16] [--rounds 1] [--train]
        [--train_batch 1 4 8] [--seed 0]

For each (dtype, batch) the edit (``edit_u8`` on device uint8 tensors,
256^2, the released flags, seeded kaiming weights scaled as
``chip_smoke.py`` scales them) runs packed and plain in turns, packed,
plain, plain, packed (ABBA, ``--rounds`` times: the host's noise moves
both routes alike), the route forced with ``SKETCHEDIT_PACK``
(``chip_smoke.edit_ab``). One line per (dtype, batch, route): ms per call
in each turn, kernel launches per call and, at B = 8 float32 (where cuDNN
picks FFT convolutions), the three costliest conv kernels. float32 runs
with TF32 off (the released setting), tf32 in float32 with TF32 allowed,
bfloat16 with TF32 allowed (the serve default). ``--train`` adds the G+D
train step at 256^2 per ``--train_batch`` in bfloat16, in float32 with
TF32 (the train CLI's default precision) and in float32 with TF32 off,
packed and plain in turns (``chip_smoke.train_ab``). Every line carries
the card's name and power limit. Needs a GPU.
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

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    edit_ab, scale_weights_, train_ab, train_batch)
from sketchedit_tpu_torch.runner import set_precision  # noqa: E402

# train-step modes: (compute dtype, precision); precision None allows TF32
TRAIN_MODES = (("bfloat16", "highest"), ("float32", None),
               ("float32", "highest"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4, 8, 32, 64])
    ap.add_argument("--dtype", nargs="+", default=["float32", "bfloat16"],
                    choices=["float32", "tf32", "bfloat16"])
    ap.add_argument("--rounds", type=int, default=1,
                    help="ABBA rounds per (dtype, batch)")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--train_batch", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("packing_ab_torch: needs a GPU")
    from sketchedit_tpu_torch.options import parse_argv
    from sketchedit_tpu_torch.options.test_options import TestOptions
    from sketchedit_tpu_torch.runner import build_pipeline
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    tmp = tempfile.TemporaryDirectory(prefix="packing_ab_")  # removed at exit
    for dtype in args.dtype:
        with contextlib.redirect_stdout(io.StringIO()):
            opt = parse_argv(TestOptions, [
                "--name", "celeb", "--checkpoints_dir", tmp.name,
                "--use_cam", "--pool_type", "max", "--joint_train_inp",
                "--init_type", "kaiming", "--compute_dtype",
                "float32" if dtype == "tf32" else dtype])
            pipe = build_pipeline(opt, seed=args.seed)
        scale_weights_(pipe.model.netM, pipe.model.netG)
        set_precision("highest" if dtype == "float32" else None)
        for B in args.batch:
            rows = edit_ab(pipe.model, B, args.seed + B,
                           top=(dtype, B) == ("float32", 8),
                           rounds=args.rounds)
            for route, row in rows.items():
                print(json.dumps({"phase": "packing_ab", "path": "edit",
                                  "dtype": dtype, "batch": B,
                                  "hw": [256, 256], "route": route, **row,
                                  "card": card}), flush=True)
        del pipe
    if args.train:
        from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
        from sketchedit_tpu_torch.train import trainer as tr
        for dtype, precision in TRAIN_MODES:
            cfg = tr.TrainConfig(netg=DeepFillConfig(attention_impl="auto"),
                                 compute_dtype=dtype, precision=precision)
            set_precision(precision)
            state = tr.init_train_state(cfg, seed=args.seed, device="cuda")
            scale_weights_(state.nets["M"], state.nets["G"])
            for B in args.train_batch:
                batch = tr.batch_to_device(
                    train_batch(B, 256, args.seed + 200 + B), "cuda")
                for route, ms in train_ab(state, cfg, batch).items():
                    print(json.dumps({
                        "phase": "packing_ab", "path": "train_step",
                        "dtype": dtype, "tf32": precision is None,
                        "batch": B, "hw": [256, 256], "route": route,
                        "ms": ms, "card": card}), flush=True)
            del state
    set_precision("highest")


if __name__ == "__main__":
    main()
