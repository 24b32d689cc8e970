"""Aspect-preserving letterbox for the batch-serving API (a copy of
``sketchedit_tpu/server/letterbox.py``).

The reference demo path preserves aspect ratio via per-side /8 rounding
(reference demo.py:43-45); the batching executor, however, wants every
request on ONE spatial shape so concurrent edits coalesce into a single
device batch. Letterboxing gives both: scale the input so its long side
fits the square canvas (aspect preserved — exactly the content the demo
path would produce at this working resolution), edge-pad to the canvas,
and crop the content region back out after the edit. Padding is
edge-replicate for the image (no artificial boundary for the mask
predictor to latch onto) and zero for the sketch (no strokes there), so
the model composites the padding back to itself and the crop discards it.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def content_size(w0: int, h0: int, canvas: int) -> tuple[int, int]:
    """Aspect-preserving size of the content region on a square canvas."""
    scale = canvas / max(w0, h0)
    return (max(1, min(canvas, round(w0 * scale))),
            max(1, min(canvas, round(h0 * scale))))


def letterbox_fit(img: Image.Image, sketch: Image.Image,
                  canvas: int) -> tuple[np.ndarray, np.ndarray,
                                        tuple[int, int]]:
    """(image u8 (canvas,canvas,3), sketch u8 (canvas,canvas,1), (w,h) of
    the content region anchored top-left)."""
    w0, h0 = img.size
    w_t, h_t = content_size(w0, h0, canvas)
    img_c = np.asarray(img.convert("RGB").resize((w_t, h_t)), np.uint8)
    sk_c = np.asarray(sketch.convert("L").resize((w_t, h_t)),
                      np.uint8)[:, :, None]
    img_u8 = np.pad(img_c, ((0, canvas - h_t), (0, canvas - w_t), (0, 0)),
                    mode="edge")
    sk_u8 = np.pad(sk_c, ((0, canvas - h_t), (0, canvas - w_t), (0, 0)))
    return img_u8, sk_u8, (w_t, h_t)


def letterbox_restore(composed_u8: np.ndarray, mask_u8: np.ndarray,
                      content_wh: tuple[int, int],
                      out_wh: tuple[int, int]) -> tuple[Image.Image,
                                                        Image.Image]:
    """Crop the content region and resize back to the original size."""
    w_t, h_t = content_wh
    w0, h0 = out_wh
    out_img = Image.fromarray(
        composed_u8[:h_t, :w_t]).resize((w0, h0))
    out_mask = Image.fromarray(
        mask_u8[:h_t, :w_t, 0]).resize((w0, h0))
    return out_img, out_mask
