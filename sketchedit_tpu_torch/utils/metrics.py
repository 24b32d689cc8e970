"""Image-quality metrics (PSNR, SSIM, masked L1) on NHWC tensors
(counterpart of ``sketchedit_tpu/utils/metrics.py``).

Each function takes (B, H, W, C) tensors, as ``models/editline2.edit``
returns them, computes in float32 and returns a (B,) float32 tensor reduced
on the inputs' device, so a caller fetches one small vector per batch.
``data_range`` defaults to 2.0 (images in [-1, 1]).

SSIM follows Wang et al. 2004 as the canonical MATLAB code implements it:
an 11x11 Gaussian window (sigma 1.5, normalized), K1 = 0.01, K2 = 0.03, a
VALID correlation (border pixels with incomplete windows are left out), the
per-channel maps averaged over channels and space.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a, b, *, data_range: float = 2.0):
    """Peak signal-to-noise ratio per image: (B,H,W,C) x 2 -> (B,)."""
    a, b = a.float(), b.float()
    mse = (a - b).square().mean(dim=(1, 2, 3))
    return 10.0 * torch.log10(data_range * data_range / mse.clamp_min(1e-12))


def masked_psnr(a, b, mask, *, data_range: float = 2.0):
    """PSNR over the pixels where mask (B,H,W,1) > 0.5 -> (B,). An empty
    mask gives a zero squared error over a count clamped to 1, so the
    1e-12 floor bounds the result."""
    a, b = a.float(), b.float()
    m = (mask.float() > 0.5).float()
    se = ((a - b).square() * m).sum(dim=(1, 2, 3))
    n = m.sum(dim=(1, 2, 3)).clamp_min(1.0) * a.shape[-1]
    mse = se / n
    return 10.0 * torch.log10(data_range * data_range / mse.clamp_min(1e-12))


def masked_l1(a, b, mask):
    """Mean |a - b| over the pixels where mask > 0.5 -> (B,)."""
    a, b = a.float(), b.float()
    m = (mask.float() > 0.5).float()
    num = ((a - b).abs() * m).sum(dim=(1, 2, 3))
    den = (m.sum(dim=(1, 2, 3)) * a.shape[-1]).clamp_min(1.0)
    return num / den


@functools.lru_cache(maxsize=4)
def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    half = (size - 1) / 2.0
    x = np.arange(size, dtype=np.float64) - half
    g = np.exp(-(x * x) / (2.0 * sigma * sigma))
    w = np.outer(g, g)
    return (w / w.sum()).astype(np.float32)


@contextlib.contextmanager
def _no_tf32_convs():
    """cuDNN may run float32 convs in TF32 (PyTorch's default, and training
    runs with --precision default); the JAX filter runs at HIGHEST."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def _filter(x, win):
    """Depthwise VALID 2-D correlation, NCHW float32: (B,C,H,W) ->
    (B,C,H',W')."""
    c = x.shape[1]
    k = torch.from_numpy(win).to(x.device)[None, None].repeat(c, 1, 1, 1)
    with _no_tf32_convs():
        return F.conv2d(x, k, groups=c)


def ssim(a, b, *, data_range: float = 2.0, window_size: int = 11,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03):
    """Structural similarity per image: (B,H,W,C) x 2 -> (B,) in [-1, 1]."""
    if a.shape[1] < window_size or a.shape[2] < window_size:
        raise ValueError(
            f"ssim needs H,W >= {window_size}, got {tuple(a.shape[1:3])}")
    a = a.float().permute(0, 3, 1, 2)
    b = b.float().permute(0, 3, 1, 2)
    win = _gaussian_window(window_size, sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_a = _filter(a, win)
    mu_b = _filter(b, win)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    # E[x^2] - E[x]^2; VALID windows, so every tap is in bounds
    s_aa = _filter(a * a, win) - mu_aa
    s_bb = _filter(b * b, win) - mu_bb
    s_ab = _filter(a * b, win) - mu_ab
    num = (2.0 * mu_ab + c1) * (2.0 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return (num / den).mean(dim=(1, 2, 3))
