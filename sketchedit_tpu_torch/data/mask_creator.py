"""Synthetic training masks (host-side, numpy/cv2); a copy of
``sketchedit_tpu/data/mask_creator.py``.

Behavioral reference: MaskCreator (the reference's models/create_mask.py):
free-form stroke masks, random square holes, DAVIS-silhouette object masks
with random scale/placement and area-retry, and object shadows; plus the
DeepFill spatial-discount map. Randomness flows through an explicit
numpy Generator (seedable per step) instead of global random state.

Mask synthesis is host-side data augmentation — cheap, branchy, and
per-sample dynamic — so it stays off-device and feeds the static-shape
device batch, like the rest of the input pipeline.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

from PIL import Image


class MaskCreator:
    def __init__(self, list_mask_path: str | None = None,
                 base_mask_path: str | None = None, match_size: bool = False,
                 rng: np.random.Generator | None = None):
        self.match_size = match_size
        self.rng = rng or np.random.default_rng()
        if list_mask_path:
            with open(list_mask_path) as f:
                self.msk_filenames = [
                    os.path.join(base_mask_path or "", line.strip("\n"))
                    for line in f]
        else:
            self.msk_filenames = None

    # -- free-form strokes ------------------------------------------------
    def stroke_mask(self, image_height=256, image_width=256, max_vertex=5,
                    max_mask=5, max_length=128):
        rng = self.rng
        max_angle = np.pi
        max_brush_width = max(1, int(max_length * 0.4))
        min_brush_width = max(1, int(max_length * 0.1))
        # uint8 raster canvas: cv2 draws the identical geometry it would
        # on the reference's float64 canvas, but the flip copies and the
        # callers' unions are ~8x cheaper (this is a loader hot path —
        # 3 external_mask calls per training item)
        mask = np.zeros((image_height, image_width), np.uint8)
        for _ in range(int(rng.integers(1, max_mask + 1))):
            num_vertex = int(rng.integers(1, max_vertex + 1))
            sx = int(rng.integers(0, image_width))
            sy = int(rng.integers(0, image_height))
            for i in range(num_vertex):
                angle = rng.uniform(0, max_angle)
                if i % 2 == 0:
                    angle = 2 * np.pi - angle
                length = rng.uniform(0, max_length)
                brush = int(rng.integers(min_brush_width,
                                         max_brush_width + 1))
                ex = min(int(sx + length * np.cos(angle)), image_width)
                ey = min(int(sy + length * np.sin(angle)), image_height)
                mask = cv2.line(mask, (sx, sy), (ex, ey), color=1,
                                thickness=brush)
                sx, sy = ex, ey
                mask = cv2.circle(mask, (sx, sy), int(brush / 2), 1)
            if rng.integers(0, 2):
                mask = mask[:, ::-1].copy()
            if rng.integers(0, 2):
                mask = mask[::-1, :].copy()
        return mask

    # -- rectangles -------------------------------------------------------
    def rectangle_mask(self, image_height=256, image_width=256,
                       min_hole_size=64, max_hole_size=128):
        rng = self.rng
        mask = np.zeros((image_height, image_width), np.uint8)
        hole = int(rng.integers(min_hole_size, max_hole_size + 1))
        hole = min(int(image_width * 0.8), int(image_height * 0.8), hole)
        x = int(rng.integers(0, image_width - hole))
        y = int(rng.integers(0, image_height - hole))
        mask[x:x + hole, y:y + hole] = 1   # reference indexes rows with x
        return mask

    # -- object silhouettes ----------------------------------------------
    def object_mask(self, image_height=256, image_width=256, _depth=0):
        if self.msk_filenames is None:
            raise NotImplementedError("no object-shape list configured")
        if _depth > 50:
            return self.rectangle_mask(image_height, image_width)
        rng = self.rng
        hb, wb = image_height, image_width
        path = self.msk_filenames[int(rng.integers(len(self.msk_filenames)))]
        m = Image.open(path)
        wm, hm = m.size
        if self.match_size:
            r = float(min(hb, wb)) / max(wm, hm) / 2
        else:
            r = 1.0
        scale = float(np.clip(rng.normal(r, 0.5), 0.5, 2.0))
        m = m.resize((int(wm * scale), int(hm * scale)))
        m = np.asarray(m) > 0
        if m.ndim == 3:
            m = m.any(-1)
        if m.sum() == 0:
            return self.object_mask(image_height, image_width, _depth + 1)
        cols = np.flatnonzero(m.sum(0))
        rows = np.flatnonzero(m.sum(1))
        m = m[rows[0]:rows[-1], cols[0]:cols[-1]]
        hm, wm = m.shape
        canvas = np.zeros((hm + hb, wm + wb))
        y = int(rng.integers(0, hb))
        x = int(rng.integers(0, wb))
        canvas[y:y + hm, x:x + wm] = m
        hole = canvas[hm // 2:hm // 2 + hb, wm // 2:wm // 2 + wb]
        th = 100 if self.match_size else 1000
        if hole.sum() < hb * wb / th:
            return self.object_mask(image_height, image_width, _depth + 1)
        return hole.astype(np.float64)

    def object_shadow(self, h, w, blur_kernel=7, noise_loc=0.5,
                      noise_range=0.05):
        rng = self.rng
        mask = self.object_mask(h, w)
        kernel = np.ones((blur_kernel + 3, blur_kernel + 3), np.float32)
        expand = cv2.dilate(mask, kernel, iterations=1)
        noise = np.minimum(rng.normal(noise_loc, noise_range, mask.shape), 1)
        mask = mask * noise
        mask = mask + (mask == 0)
        box = np.ones((blur_kernel, blur_kernel), np.float32) / blur_kernel**2
        mask = cv2.filter2D(mask, -1, box)
        return mask, expand


def external_mask(creator: MaskCreator, h: int, w: int, *,
                  use_object_masks: bool = True):
    """Train-time random edit region: a stroke mask unioned with an
    object (p=0.5) or rectangle mask (editline2_model.py:206-221)."""
    m1 = creator.stroke_mask(h, w, max_length=min(h, w) / 2)
    ri = int(creator.rng.integers(0, 4))
    if use_object_masks and creator.msk_filenames is not None and ri <= 1:
        m2 = creator.object_mask(h, w)
    else:
        m2 = creator.rectangle_mask(h, w, min(h, w) // 4, min(h, w) // 2)
    return ((m1 + m2) > 0).astype(np.float32)


def spatial_discount(mask: np.ndarray, gamma: float = 0.9) -> np.ndarray:
    """DeepFill's gamma^distance boundary-decay map
    (create_mask.py:119-145), vectorized."""
    H, W = mask.shape
    up = np.zeros_like(mask)
    up[:-1] = mask[1:]
    left = np.zeros_like(mask)
    left[:, :-1] = mask[:, 1:]
    boundary = (np.abs(mask - up) + np.abs(mask - left)) != 0
    if not boundary.any():
        return np.zeros_like(mask)
    yy, xx = np.meshgrid(range(H), range(W), indexing="ij")
    by, bx = np.nonzero(boundary)
    d = np.sqrt((xx[..., None] - bx[None, None]) ** 2 +
                (yy[..., None] - by[None, None]) ** 2).min(-1)
    return (gamma ** d) * mask
