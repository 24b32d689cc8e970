"""EditLine2, the sketch-edit pipeline: netM, netG and the composite
(counterpart of ``sketchedit_tpu/models/editline2.py``).

    soft_mask, mask_image = netM(image, sketch)
    hard_mask = soft_mask > 0.5                      # fed to netG
    coarse, fake = netG(image, image, hard_mask, hard_mask, sketch)
    composed = fake * soft_mask + image * (1 - soft_mask)

``generate`` and ``pad_to_grid`` work in NCHW. The public ``edit`` and
``edit_u8`` take and return NHWC, as the JAX functions do.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn as nn
import torch.nn.functional as F

from sketchedit_tpu_torch.models.deepfill_c2 import (
    DeepFillC2Generator, DeepFillConfig)
from sketchedit_tpu_torch.models.md_generator import MDGenerator
from sketchedit_tpu_torch.ops.gated_conv import init_conv_

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class EditLine2Config:
    netg: DeepFillConfig = field(default_factory=DeepFillConfig)
    mask_threshold: float = 0.5
    precision: str | None = "highest"   # 'highest': no TF32 (see runner)
    compute_dtype: str = "float32"      # 'float32' | 'bfloat16'

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]


class EditLine2(nn.Module):
    """netM and netG under one module, in ``config.compute_dtype``."""

    def __init__(self, config: EditLine2Config = EditLine2Config(), *,
                 device=None):
        super().__init__()
        self.config = config
        self.netM = MDGenerator(device=device, dtype=config.dtype)
        self.netG = DeepFillC2Generator(config.netg, device=device,
                                        dtype=config.dtype)


def init_nets_(model: EditLine2, labels, seed: int, *,
               init_type: str = "xavier", gain: float = 0.02):
    """Re-initialize the nets named by ``labels`` ('M', 'G') in place. Each
    net has its own generator, so its weights depend on the seed alone."""
    for label in labels:
        gen = torch.Generator().manual_seed(2 * seed + ("M", "G").index(label))
        for conv in getattr(model, f"net{label}").children():
            init_conv_(conv, gen, init_type=init_type, gain=gain)


def generate(model: EditLine2, image, sketch):
    """Eval-mode forward on NCHW tensors; returns every intermediate."""
    dt = model.config.dtype
    image = image.to(dt)
    sketch = sketch.to(dt)
    soft_mask, mask_image = model.netM(image, sketch)
    hard_mask = (soft_mask > model.config.mask_threshold).to(dt)
    coarse, fake = model.netG(image, image, hard_mask, hard_mask, sketch)
    return {"coarse": coarse, "fake": fake, "mask": soft_mask,
            "mask_image": mask_image, "mask_inpaint": hard_mask}


def pad_to_grid(image, sketch, multiple: int = 8):
    """Edge-pad the NCHW image and zero-pad the sketch on the bottom and
    right up to the next multiple of ``multiple``, and to at least 16 px a
    side (below that the H/4 attention patch grid is empty). Returns
    (image, sketch, (H, W)) with the original size."""
    H, W = image.shape[2:]
    th = max(16, H + (-H) % multiple)
    tw = max(16, W + (-W) % multiple)
    ph, pw = th - H, tw - W
    if not (ph or pw):
        return image, sketch, (H, W)
    image = F.pad(image, (0, pw, 0, ph), mode="replicate")
    sketch = F.pad(sketch, (0, pw, 0, ph))
    return image, sketch, (H, W)


def edit(model: EditLine2, image, sketch):
    """(image (B,H,W,3) in [-1,1], sketch (B,H,W,1) in {0,1}) ->
    (composed (B,H,W,3), soft_mask (B,H,W,1)), NHWC. Any H, W >= 1: the
    inputs are padded to the /8 grid and the outputs cropped back."""
    H, W = image.shape[1:3]
    image = image.permute(0, 3, 1, 2)
    sketch = sketch.permute(0, 3, 1, 2)
    image_p, sketch_p, _ = pad_to_grid(image, sketch, 8)
    out = generate(model, image_p, sketch_p)
    soft = out["mask"][:, :, :H, :W]
    fake = out["fake"][:, :, :H, :W]
    composed = fake * soft + image.to(soft.dtype) * (1.0 - soft)
    return composed.permute(0, 2, 3, 1), soft.permute(0, 2, 3, 1)


def edit_u8(model: EditLine2, image_u8, sketch_u8):
    """uint8 in, uint8 out: image (B,H,W,3), sketch (B,H,W,1) with 0 = no
    stroke -> (composed (B,H,W,3), mask (B,H,W,1)). ``torch.round`` rounds
    half to even, as ``jnp.round`` does."""
    dt = model.config.dtype
    image = image_u8.to(dt) / 127.5 - 1.0
    sketch = (sketch_u8 > 0).to(dt)
    composed, mask = edit(model, image, sketch)
    composed_u8 = torch.round(
        (torch.clamp(composed, -1, 1) + 1.0) * 127.5).to(torch.uint8)
    mask_u8 = torch.round(torch.clamp(mask, 0, 1) * 255.0).to(torch.uint8)
    return composed_u8, mask_u8
