"""Held-out validation during training and the JSONL metrics log
(counterpart of ``sketchedit_tpu/train/validation.py``).

* ``Validator``: a fixed, deterministic held-out batch scored through the
  real eval path (``models/editline2.edit``: netM's soft mask thresholded
  at 0.5 for netG, the soft-mask composite) with ``utils/metrics.py``'s
  PSNR, SSIM, region PSNR, region L1 and outside-region L1, plus netM's
  IoU at 0.5 against the sampled region. Each call reduces on the nets'
  device and fetches six scalars.
* ``MetricsLog``: append-only JSONL, one object a line, each line flushed
  as written so that a preempted run keeps what it wrote. The train CLI
  logs a ``kind: "train"`` row at every print and a ``kind: "val"`` row per
  validation.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from types import SimpleNamespace

import numpy as np
import torch

from sketchedit_tpu_torch.data import find_dataset_using_name
from sketchedit_tpu_torch.models import editline2
from sketchedit_tpu_torch.models.editline2 import EditLine2Config
from sketchedit_tpu_torch.utils import metrics


class MetricsLog:
    """Append-only JSONL metrics log."""

    def __init__(self, path):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)

    @staticmethod
    def from_opt(opt):
        """Resolve --metrics_log: 'auto' -> <run_dir>/metrics.jsonl,
        'off' -> None, anything else is an explicit path."""
        spec = getattr(opt, "metrics_log", "off")
        if spec == "off":
            return None
        if spec == "auto":
            spec = os.path.join(opt.checkpoints_dir, opt.name,
                                "metrics.jsonl")
        return MetricsLog(spec)

    def log(self, row: dict):
        json.dump(row, self._f, allow_nan=True)
        self._f.write("\n")

    def close(self):
        self._f.close()


# sign convention for --val_track best-checkpoint selection
HIGHER_IS_BETTER = {"psnr": True, "ssim": True, "region_psnr": True,
                    "mask_iou": True, "region_l1": False,
                    "outside_l1": False}


def resolve_val_track(opt) -> str:
    """'auto' -> mask_iou when the mask has supervision, else psnr.

    With --lambda_mask_rec > 0 the mask is trained, and every
    reconstruction metric rewards the zero-mask collapse: the inputs are
    the target, so a zero soft mask composites the input back and scores a
    perfect reconstruction. mask_iou is the metric the collapse cannot
    game."""
    track = getattr(opt, "val_track", "auto")
    if track != "auto":
        return track
    return ("mask_iou" if getattr(opt, "lambda_mask_rec", 0) > 0
            else "psnr")


def is_improvement(metric: str, value: float, best: float | None) -> bool:
    if best is None:
        return True
    return value > best if HIGHER_IS_BETTER[metric] else value < best


def recover_best(metrics_log_path: str, metric: str) -> float | None:
    """The best tracked val value in an existing metrics.jsonl, so that
    --continue_train keeps the historic best instead of overwriting
    best_net_* with the first validation after the resume."""
    if not os.path.exists(metrics_log_path):
        return None
    best = None
    with open(metrics_log_path) as f:
        for line in f:
            try:
                row = json.loads(line)
            except ValueError:
                continue                      # a torn tail line from a kill
            if row.get("kind") == "val" and metric in row:
                v = row[metric]
                if isinstance(v, (int, float)) and not math.isnan(v) \
                        and is_improvement(metric, v, best):
                    best = float(v)
    return best


def build_validator(opt, train_cfg):
    """A Validator over --val_image_dir, or None when the flag is unset."""
    val_dir = getattr(opt, "val_image_dir", "")
    if not val_dir:
        return None
    return Validator(opt, train_cfg, val_dir,
                     items=getattr(opt, "val_items", 8))


class Validator:
    """Scores netM and netG of a train state on a fixed held-out batch:
    the training preprocessing over ``val_dir`` in a fixed order, without
    photometric jitter, each item drawn after ``reseed((seed, 0, i))``."""

    def __init__(self, opt, train_cfg, val_dir, *, items=8, seed=7):
        vopt = argparse.Namespace(**vars(opt))
        vopt.train_image_dir = val_dir
        vopt.train_image_list = ""
        vopt.serial_batches = True
        vopt.cjit = None
        ds = find_dataset_using_name("editimage")()
        ds.initialize(vopt, seed=seed)
        if len(ds) == 0:
            raise ValueError(f"--val_image_dir {val_dir}: no images found")
        picked = []
        for i in range(min(items, len(ds))):
            ds.reseed((seed, 0, i))       # item-keyed draws: stable per run
            picked.append(ds[i])
        self.image = np.stack([it["image_u8"].astype(np.float32) / 127.5
                               - 1.0 for it in picked])
        self.sketch = np.stack([it["mask"].astype(np.float32)
                                for it in picked])
        self.region = np.stack([it["region_gt"].astype(np.float32)
                                for it in picked])
        # float32 whatever the train compute dtype: validation tracks
        # quality, and bfloat16 metric jitter would alias as signal
        self.config = EditLine2Config(
            netg=train_cfg.netg, precision=train_cfg.precision,
            compute_dtype="float32")
        self._inputs = None               # the batch on the nets' device

    def _on(self, device):
        if self._inputs is None or self._inputs[0].device != device:
            self._inputs = tuple(torch.from_numpy(a).to(device) for a in
                                 (self.image, self.sketch, self.region))
        return self._inputs

    def run(self, nets) -> dict:
        """Score the held-out batch with ``nets`` (the train state's
        {'M', 'G', 'D'} modules; edit reads M and G) on their device, in
        eval mode and without autograd; returns {metric: float}."""
        image, sketch, region = self._on(
            next(nets["G"].parameters()).device)
        model = SimpleNamespace(config=self.config, netM=nets["M"],
                                netG=nets["G"])
        modes = {k: nets[k].training for k in ("M", "G")}
        try:
            for k in modes:
                nets[k].eval()
            with torch.no_grad():
                composed, soft = editline2.edit(model, image, sketch)
                composed = composed.float()
                hard = (soft.float() > 0.5).float()
                inter = (hard * region).sum(dim=(1, 2, 3))
                union = torch.maximum(hard, region).sum(
                    dim=(1, 2, 3)).clamp_min(1.0)
                out = {
                    "psnr": metrics.psnr(composed, image),
                    "ssim": metrics.ssim(composed, image),
                    "region_psnr": metrics.masked_psnr(composed, image,
                                                       region),
                    "region_l1": metrics.masked_l1(composed, image, region),
                    "outside_l1": metrics.masked_l1(composed, image,
                                                    1.0 - region),
                    "mask_iou": inter / union,
                }
                means = torch.stack([v.mean() for v in out.values()]).cpu()
        finally:
            for k, was in modes.items():
                nets[k].train(was)
        return {k: float(v) for k, v in zip(out, means)}
