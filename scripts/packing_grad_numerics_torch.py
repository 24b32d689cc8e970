#!/usr/bin/env python3
"""How far the gradients of one float32 train step at 256^2, B = 8 move
between the packed and the plain fronts and tails (ops/packed_tail.py), on
one GPU (TF32 off, lr 0, flags 1, 1, the contextual attention on its
kernels): with cuDNN's default algorithm choice, with
``cudnn.deterministic`` and with cuDNN off on both routes, from
chip_smoke.py's scaled weights and from the train state's own
initialisation (``init_train_state``, unscaled).

    python3 scripts/packing_grad_numerics_torch.py [--seed 0]

Prints one JSON line per (weights, cuDNN mode): per net, the worst relative
L2 error over its gradient tensors (packed against plain, and the plain
step run again against itself) and the tensor that has it; then the card's
name and power limit. The batch is chip_smoke.py's ``batch8``."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import env, scale_weights_, train_batch  # noqa: E402
from dp_grad_numerics_torch import worst  # noqa: E402
from sketchedit_tpu_torch.models.deepfill_c2 import (  # noqa: E402
    DeepFillConfig)
from sketchedit_tpu_torch.runner import set_precision  # noqa: E402
from sketchedit_tpu_torch.train import trainer as tr  # noqa: E402


def grads(seed, rows, scaled: bool, pack: str):
    """Gradients of one lr-0 step (flags 1, 1) from a seeded state on
    ``rows``, the route forced with SKETCHEDIT_PACK."""
    cfg = tr.TrainConfig(netg=DeepFillConfig(attention_impl="kernel"),
                         precision="highest", lr=0.0)
    state = tr.init_train_state(cfg, seed=seed, device="cuda")
    if scaled:
        scale_weights_(state.nets["M"], state.nets["G"])
    with env(SKETCHEDIT_PACK=pack):
        tr.train_step(state, tr.batch_to_device(rows, "cuda"), 1, 1, cfg)
    return {f"{label}.{n}": p.grad.detach().clone()
            for label, net in state.nets.items()
            for n, p in net.named_parameters()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    set_precision("highest")
    data = train_batch(8, 256, args.seed + 200)   # chip_smoke.py's batch8
    for weights in ("scaled", "init"):
        for mode in ("default", "deterministic", "no_cudnn"):
            torch.backends.cudnn.enabled = mode != "no_cudnn"
            torch.backends.cudnn.deterministic = mode == "deterministic"
            scaled = weights == "scaled"
            plain = grads(args.seed, data, scaled, "0")
            again = grads(args.seed, data, scaled, "0")
            packed = grads(args.seed, data, scaled, "1")
            print(json.dumps({"weights": weights, "cudnn": mode,
                              "packed_vs_plain": worst(packed, plain),
                              "plain_again_vs_plain": worst(again, plain)}),
                  flush=True)
    torch.backends.cudnn.enabled = True
    torch.backends.cudnn.deterministic = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
