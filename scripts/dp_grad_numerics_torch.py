#!/usr/bin/env python3
"""How far the gradients of one float32 train step at 256^2 move with the
batch's split alone, on one GPU (TF32 off, lr 0): the step on the whole
batch of 8, the same step again, and the mean of the steps on its two
halves (what two data-parallel ranks average), each with cuDNN's default
algorithm choice, with ``cudnn.deterministic``, and with cuDNN off.

    python3 scripts/dp_grad_numerics_torch.py [--seed 0]

Prints one JSON line per comparison: per net, the worst relative L2 error
over its gradient tensors and the tensor that has it, then the card's name
and power limit. Weights and batch are chip_smoke.py's (seeded)."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import scale_weights_, train_batch  # noqa: E402
from sketchedit_tpu_torch.models.deepfill_c2 import (  # noqa: E402
    DeepFillConfig)
from sketchedit_tpu_torch.runner import set_precision  # noqa: E402
from sketchedit_tpu_torch.train import trainer as tr  # noqa: E402


def grads(seed, rows):
    """Gradients of one lr-0 step (flags 1, 1) from chip_smoke.py's seeded
    state on ``rows``."""
    cfg = tr.TrainConfig(netg=DeepFillConfig(attention_impl="kernel"),
                         precision="highest", lr=0.0)
    state = tr.init_train_state(cfg, seed=seed, device="cuda")
    scale_weights_(state.nets["M"], state.nets["G"])
    tr.train_step(state, tr.batch_to_device(rows, "cuda"), 1, 1, cfg)
    return {f"{label}.{n}": p.grad.detach().clone()
            for label, net in state.nets.items()
            for n, p in net.named_parameters()}


def worst(got, want):
    out = {}
    for k, w in want.items():
        norm = w.norm().item()
        err = ((got[k] - w).norm().item() / norm if norm
               else (got[k] - w).abs().max().item())
        net = k.split(".")[0]
        if err >= out.get(net, (0.0, ""))[0]:
            out[net] = (err, k)
    return {net: {"rel_l2": e, "tensor": k} for net, (e, k) in out.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU")
    set_precision("highest")
    data = train_batch(8, 256, args.seed + 200)   # chip_smoke.py's batch8
    halves = [{k: v[i * 4:(i + 1) * 4] for k, v in data.items()}
              for i in range(2)]
    for mode in ("default", "deterministic", "no_cudnn"):
        torch.backends.cudnn.enabled = mode != "no_cudnn"
        torch.backends.cudnn.deterministic = mode == "deterministic"
        whole = grads(args.seed, data)
        again = grads(args.seed, data)
        parts = [grads(args.seed, h) for h in halves]
        mean = {k: (parts[0][k] + parts[1][k]) / 2 for k in whole}
        print(json.dumps({"cudnn": mode, "B8_again_vs_B8": worst(again, whole),
                          "mean_of_B4_halves_vs_B8": worst(mean, whole)}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
