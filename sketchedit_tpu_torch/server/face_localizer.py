"""Bundled face localizer: multi-scale normalized cross-correlation
against an average-face template built from the repo's release assets (a
copy of ``sketchedit_tpu/server/face_localizer.py``).

The reference README advertises face-in-fullbody editing but ships no
detector (SURVEY.md §C2), and this environment ships no pretrained
detector weights (cv2 5.0 has no CascadeClassifier data, no downloads).
This is a REAL image-content localizer — it finds a face with no sketch
strokes at all — built from what the repo legitimately bundles: the
average of the CelebAHQ release faces as a 32x32 grayscale template,
scanned over an image pyramid with cv2.matchTemplate(TM_CCOEFF_NORMED)
and greedy NMS.

Scope honestly stated: an average-face correlation template generalizes
to frontal, roughly upright faces (the CelebAHQ aligned distribution) —
it is a capability floor, not a modern detector. `composite.
face_crop_edit(detector=...)` accepts any stronger box-producing callable
as a drop-in; the sketch+skin-blob heuristic remains the fallback when
this returns nothing.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_FACE_DIRS = (
    os.path.join(REPO, "datasets", "face_release", "images"),
)

TEMPLATE_SIZE = 32
# CelebAHQ release images are aligned head crops; the face occupies
# roughly the central 60% — crop that so the template is a face, not a
# face-plus-background
_FACE_CROP_FRAC = 0.62
_SCALES = (0.08, 0.12, 0.17, 0.24, 0.33, 0.45, 0.62)   # face/short-side
_THRESHOLD = 0.42
_NMS_IOU = 0.3

_template_cache: dict = {}


def _average_face_template(size: int = TEMPLATE_SIZE) -> np.ndarray | None:
    """Mean grayscale face from the bundled release assets (None if the
    assets are absent or cv2 is unavailable — callers degrade to the
    sketch/skin heuristic)."""
    if cv2 is None:
        return None
    if size in _template_cache:
        return _template_cache[size]
    faces = []
    for d in _FACE_DIRS:
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if not name.lower().endswith((".png", ".jpg", ".jpeg")):
                continue
            img = cv2.imread(os.path.join(d, name))
            if img is None:
                continue
            g = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            h, w = g.shape
            m = int(min(h, w) * _FACE_CROP_FRAC)
            y0, x0 = (h - m) // 2, (w - m) // 2
            faces.append(cv2.resize(g[y0:y0 + m, x0:x0 + m], (size, size),
                                    interpolation=cv2.INTER_AREA)
                         .astype(np.float32))
        if faces:
            break
    tmpl = np.mean(faces, axis=0) if faces else None
    _template_cache[size] = tmpl
    return tmpl


def _iou(a, b) -> float:
    ax0, ay0, aw, ah = a
    bx0, by0, bw, bh = b
    ix0, iy0 = max(ax0, bx0), max(ay0, by0)
    ix1, iy1 = min(ax0 + aw, bx0 + bw), min(ay0 + ah, by0 + bh)
    inter = max(0, ix1 - ix0) * max(0, iy1 - iy0)
    union = aw * ah + bw * bh - inter
    return inter / union if union else 0.0


def detect(image_u8: np.ndarray, *, threshold: float = _THRESHOLD,
           max_boxes: int = 4) -> list:
    """-> [(x, y, w, h), ...] ordered by score (possibly empty).

    Matches composite.localize_edit_region's `detector` contract."""
    tmpl = _average_face_template()
    if cv2 is None or tmpl is None or image_u8.ndim != 3:
        return []
    gray = cv2.cvtColor(image_u8, cv2.COLOR_RGB2GRAY).astype(np.float32)
    H, W = gray.shape
    short = min(H, W)
    cands = []
    for frac in _SCALES:
        face_px = frac * short
        if face_px < TEMPLATE_SIZE * 0.6 or face_px > short:
            continue
        # resize the IMAGE so a face of this size maps onto the template
        r = TEMPLATE_SIZE / face_px
        rw, rh = max(TEMPLATE_SIZE, int(W * r)), max(TEMPLATE_SIZE,
                                                     int(H * r))
        small = cv2.resize(gray, (rw, rh), interpolation=cv2.INTER_AREA)
        res = cv2.matchTemplate(small, tmpl, cv2.TM_CCOEFF_NORMED)
        ys, xs = np.nonzero(res >= threshold)
        for y, x in zip(ys.tolist(), xs.tolist()):
            side = int(round(TEMPLATE_SIZE / r / _FACE_CROP_FRAC))
            # map the template's central-face crop back to a full-head box
            off = int(round((side - TEMPLATE_SIZE / r) / 2))
            bx = int(round(x / r)) - off
            by = int(round(y / r)) - off
            cands.append((float(res[y, x]),
                          (max(0, bx), max(0, by),
                           min(side, W - max(0, bx)),
                           min(side, H - max(0, by)))))
    cands.sort(key=lambda c: -c[0])
    kept = []
    for score, box in cands:
        if all(_iou(box, k) < _NMS_IOU for k in kept):
            kept.append(box)
            if len(kept) >= max_boxes:
                break
    return kept
