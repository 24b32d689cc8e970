"""Image-space ops, NCHW (counterpart of ``sketchedit_tpu/ops/image.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def nearest_upsample2x(x: torch.Tensor) -> torch.Tensor:
    """x2 nearest upsample (``F.interpolate(scale_factor=2)``)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def avg_pool2d(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Average pool with VALID padding."""
    return F.avg_pool2d(x, window, stride)


def _gaussian_kernel(kernel_size: int, sigma: float) -> torch.Tensor:
    """2-D gaussian grid normalized to sum 1 (the reference's
    get_gaussian_kernel)."""
    coords = torch.arange(kernel_size, dtype=torch.float32)
    yg, xg = torch.meshgrid(coords, coords, indexing="ij")
    mean = (kernel_size - 1) / 2.0
    var = sigma ** 2
    g = (1.0 / (2.0 * math.pi * var)) * torch.exp(
        -((xg - mean) ** 2 + (yg - mean) ** 2) / (2 * var))
    return g / g.sum()


def gaussian_blur3x3(x: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Depthwise 3x3 gaussian blur with replicate padding (the reference's
    fixed blur for the --filt_maskim training loss)."""
    C = x.shape[1]
    w = _gaussian_kernel(3, sigma).to(x.device, x.dtype).expand(C, 1, 3, 3)
    return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="replicate"), w, groups=C)
