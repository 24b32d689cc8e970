"""Image-space ops, NCHW (counterpart of ``sketchedit_tpu/ops/image.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def nearest_upsample2x(x: torch.Tensor) -> torch.Tensor:
    """x2 nearest upsample (``F.interpolate(scale_factor=2)``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool2d(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Average pool with VALID padding."""
    return F.avg_pool2d(x, window, stride)
