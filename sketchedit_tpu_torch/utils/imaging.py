"""Array <-> image helpers, NHWC numpy (a copy of the parts of
``sketchedit_tpu/utils/imaging.py`` that the batch CLI uses)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def tensor2im(arr):
    """(H,W,C) or (B,H,W,C) float in [-1,1] -> uint8 RGB [0,255]."""
    arr = np.asarray(arr, dtype=np.float32)
    out = (np.clip(arr, -1.0, 1.0) + 1.0) / 2.0 * 255.0
    return out.astype(np.uint8)


def mask2im(arr):
    """(H,W,1)/(B,H,W,1) float in [0,1] -> uint8 grayscale."""
    arr = np.asarray(arr, dtype=np.float32)
    out = np.clip(arr, 0.0, 1.0) * 255.0
    return np.squeeze(out, axis=-1).astype(np.uint8)


def save_image(image_np: np.ndarray, path: str):
    if image_np.ndim == 3 and image_np.shape[2] == 1:
        image_np = image_np[:, :, 0]
    Image.fromarray(image_np).save(path)
