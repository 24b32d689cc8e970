"""Crop-edit-paste composite: edit a face inside a full-body photo (a copy
of ``sketchedit_tpu/server/composite.py``; numpy and optional OpenCV).

The reference README advertises this ("edit face in a fullbody photo",
README.md:15-16) but ships no implementation (SURVEY.md §C2) — the demo
sends the whole resized image through the model. This is the greenfield
realization for the BASELINE "full-body photo face edit" config:

  localize the face region around the user's sketch -> crop an expanded
  square -> resize to the model's native 256 -> edit -> resize back ->
  feather-blend the edited crop over the original.

Localization (offline, no model downloads): the sketch strokes themselves
anchor the region — the user draws on the face — refined by a skin-
probability blob (YCrCb chroma gate) around the strokes. Plug in a real
detector via the `detector` argument when one is available.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

EDIT_RES = 256
EXPAND = 1.8      # crop box expansion around the localized region
FEATHER = 0.12    # feather width as a fraction of the crop size


def _resize_linear(arr: np.ndarray, wh: tuple) -> np.ndarray:
    """Bilinear resize of a float array; PIL per-channel when cv2 is
    absent (the whole composite path must degrade, not crash, without
    cv2 — the module import guard exists for exactly that host)."""
    if cv2 is not None:
        return cv2.resize(arr, wh, interpolation=cv2.INTER_LINEAR)
    from PIL import Image
    w, h = wh
    if arr.ndim == 2:
        return np.asarray(Image.fromarray(arr.astype(np.float32), "F")
                          .resize((w, h), Image.BILINEAR), np.float32)
    return np.stack(
        [np.asarray(Image.fromarray(arr[..., c].astype(np.float32), "F")
                    .resize((w, h), Image.BILINEAR), np.float32)
         for c in range(arr.shape[-1])], axis=-1)


def _resize_nearest2d(arr2d: np.ndarray, wh: tuple) -> np.ndarray:
    """Nearest-neighbor resize of a 2-D map (binary sketch), cv2-free."""
    if cv2 is not None:
        return cv2.resize(arr2d, wh, interpolation=cv2.INTER_NEAREST)
    w, h = wh
    H, W = arr2d.shape
    yi = np.minimum((np.arange(h) * (H / h)).astype(int), H - 1)
    xi = np.minimum((np.arange(w) * (W / w)).astype(int), W - 1)
    return arr2d[yi[:, None], xi[None, :]]


def skin_mask(image_u8: np.ndarray) -> np.ndarray:
    """Coarse skin-probability mask via YCrCb chroma gating."""
    ycrcb = cv2.cvtColor(image_u8, cv2.COLOR_RGB2YCrCb)
    cr = ycrcb[:, :, 1].astype(np.int32)
    cb = ycrcb[:, :, 2].astype(np.int32)
    m = ((cr >= 135) & (cr <= 180) & (cb >= 85) & (cb <= 135)).astype(
        np.uint8)
    m = cv2.morphologyEx(m, cv2.MORPH_OPEN, np.ones((5, 5), np.uint8))
    m = cv2.morphologyEx(m, cv2.MORPH_CLOSE, np.ones((9, 9), np.uint8))
    return m


def localize_edit_region(image_u8: np.ndarray, sketch_hw1: np.ndarray,
                         detector=None):
    """-> (x, y, w, h) box around the region to edit, or None.

    Priority: external detector -> skin blob containing/near the sketch ->
    sketch stroke bounding box.
    """
    H, W = image_u8.shape[:2]
    ys, xs = np.nonzero(sketch_hw1[:, :, 0] > 0)
    if detector is not None:
        boxes = detector(image_u8)
        if boxes:
            if not len(xs):
                return max(boxes, key=lambda b: b[2] * b[3])
            cx, cy = xs.mean(), ys.mean()
            return min(boxes, key=lambda b: (b[0] + b[2] / 2 - cx) ** 2
                       + (b[1] + b[3] / 2 - cy) ** 2)
    if not len(xs):
        return None

    sx0, sx1 = xs.min(), xs.max()
    sy0, sy1 = ys.min(), ys.max()

    if cv2 is not None:      # skin-blob refinement needs cv2; without it
        skin = skin_mask(image_u8)   # the sketch bbox below still works
        n, labels, stats, _ = cv2.connectedComponentsWithStats(skin)
        best = None
        cx, cy = int(xs.mean()), int(ys.mean())
        for i in range(1, n):
            x, y, w, h, area = stats[i]
            if area < 0.0005 * H * W:
                continue
            if x <= cx < x + w and y <= cy < y + h:
                if best is None or area > best[-1]:
                    best = (x, y, w, h, area)
        if best is not None:
            x, y, w, h, _ = best
            # union with the sketch extent so strokes stay inside the crop
            x0, y0 = min(x, sx0), min(y, sy0)
            x1, y1 = max(x + w, sx1), max(y + h, sy1)
            return (x0, y0, x1 - x0, y1 - y0)
    return (sx0, sy0, max(1, sx1 - sx0), max(1, sy1 - sy0))


def _square_crop(box, shape):
    x, y, w, h = box
    H, W = shape[:2]
    cx, cy = x + w / 2, y + h / 2
    side = int(max(w, h) * EXPAND)
    side = max(32, min(side, H, W))
    x0 = int(np.clip(cx - side / 2, 0, W - side))
    y0 = int(np.clip(cy - side / 2, 0, H - side))
    return x0, y0, side


def _feather_mask(side: int) -> np.ndarray:
    """Cosine-ramped blend mask, 1 in the center, 0 at the border."""
    f = max(2, int(side * FEATHER))
    ramp = 0.5 - 0.5 * np.cos(np.linspace(0, np.pi, f))
    line = np.ones(side, np.float32)
    line[:f] = ramp
    line[-f:] = ramp[::-1]
    return np.minimum.outer(line, line)[:, :, None]


def face_crop_edit(pipeline, image: np.ndarray, sketch: np.ndarray,
                   detector=None):
    """image: (H, W, 3) float32 in [-1,1]; sketch: (H, W, 1) {0,1}.

    Returns the composited (H, W, 3) edit. Falls back to whole-image
    editing when no region can be localized.
    """
    img_u8 = ((image + 1) / 2 * 255).astype(np.uint8)
    box = localize_edit_region(img_u8, sketch, detector)
    if box is None:
        composed, _ = pipeline(image[None], sketch[None])
        return np.asarray(composed[0], np.float32)

    x0, y0, side = _square_crop(box, image.shape)
    crop = image[y0:y0 + side, x0:x0 + side]
    sk_crop = sketch[y0:y0 + side, x0:x0 + side]

    crop_r = _resize_linear(crop, (EDIT_RES, EDIT_RES))
    sk_r = _resize_nearest2d(sk_crop[:, :, 0],
                             (EDIT_RES, EDIT_RES))[:, :, None]
    composed, _mask = pipeline(
        crop_r[None], (sk_r > 0).astype(np.float32)[None])
    edited = np.asarray(composed[0], np.float32)

    edited_back = _resize_linear(edited, (side, side))
    blend = _feather_mask(side)
    out = image.copy()
    out[y0:y0 + side, x0:x0 + side] = (
        edited_back * blend + crop * (1 - blend))
    return out
