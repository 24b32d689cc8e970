"""Image preprocessing for the test-image loader (a copy of the parts of
``sketchedit_tpu/data/transforms.py`` that ``testimage`` uses)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def image_to_array(img: Image.Image) -> np.ndarray:
    """PIL -> float32 HWC array mapped from [0,255] to [-1,1]
    (ToTensor + Normalize(0.5, 0.5))."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return (arr - 0.5) / 0.5


def binarize_sketch(img: Image.Image, size_wh) -> np.ndarray:
    """Grayscale sketch -> {0,1} float32 HW1, resized to the image's size
    first."""
    if img.size != size_wh:
        img = img.resize(size_wh)
    arr = np.asarray(img.convert("L"), dtype=np.float32)
    return (arr > 0).astype(np.float32)[:, :, None]
