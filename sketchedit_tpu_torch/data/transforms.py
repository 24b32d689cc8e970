"""Image preprocessing with the reference's preprocess-mode vocabulary (a
copy of ``sketchedit_tpu/data/transforms.py``).

Mirrors data/base_dataset.py:22-86: modes resize_and_crop, crop,
scale_width(_and_crop), scale_shortside(_and_crop), fixed, none (-> round to
multiple of 32). Randomness (crop position, flip) comes from an explicit
numpy Generator instead of global random state, so host-side augmentation is
reproducible and per-sample seedable — the JAX-style answer to the
reference's shared-seed trick for paired transforms (apply the same
TransformParams to image and sketch).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from PIL import Image


@dataclass
class TransformParams:
    crop_pos: tuple[int, int]
    flip: bool
    new_size: tuple[int, int]       # (w, h) after the resize stage
    jitter: tuple | None = None     # (order, (brightness, contrast,
    #                                  saturation, hue)) — see color_jitter


def get_params(opt, size, rng: np.random.Generator | None = None, *,
               size_is_resized: bool = False):
    """size_is_resized=True: `size` is the ALREADY-resized frame (the
    cached-decode path) — use it as the crop bound directly. The
    reference always feeds the ORIGINAL size and recomputes new_size
    (base_dataset.py:22-35), and apply_resize realizes exactly that
    size, so the two are equivalent — but the recomputation is NOT
    idempotent for scale_shortside_and_crop (the preserved reference
    quirk keeps the short side unchanged, so re-deriving from the
    resized size double-scales the long side and draws crop positions
    past the frame edge)."""
    w, h = size
    new_w, new_h = w, h
    mode = opt.preprocess_mode
    if size_is_resized:
        pass
    elif mode == 'resize_and_crop':
        new_w = new_h = opt.load_size
    elif mode == 'scale_width_and_crop':
        new_w = opt.load_size
        new_h = opt.load_size * h // w
    elif mode == 'scale_shortside_and_crop':
        ss, ls = min(w, h), max(w, h)
        ls = int(opt.load_size * ls / ss)
        new_w, new_h = (ss, ls) if w == ss else (ls, ss)

    rng = rng or np.random.default_rng()
    # reference base_dataset.py:37-38 random.randint is INCLUSIVE of the
    # upper bound — the right/bottom-most crop position must be reachable
    x = int(rng.integers(0, max(0, new_w - opt.crop_size) + 1))
    y = int(rng.integers(0, max(0, new_h - opt.crop_size) + 1))
    flip = bool(rng.random() > 0.5)

    # --cjit (base_dataset.py:69-70: ColorJitter(c, c, c, c) at train
    # time): torchvision sampling — multiplicative factors from
    # U[max(0, 1-c), 1+c], hue shift from U[-min(c, .5), min(c, .5)],
    # applied in a random order.
    jitter = None
    c = getattr(opt, "cjit", None)
    if getattr(opt, "isTrain", False) and c is not None:
        def factor():
            return float(rng.uniform(max(0.0, 1.0 - c), 1.0 + c))
        hue_amp = min(float(c), 0.5)
        jitter = (tuple(rng.permutation(4)),
                  (factor(), factor(), factor(),
                   float(rng.uniform(-hue_amp, hue_amp))))
    return TransformParams((x, y), flip, (new_w, new_h), jitter)


def _scale_width(img, target, method):
    ow, oh = img.size
    if ow == target:
        return img
    return img.resize((target, int(target * oh / ow)), method)


def _scale_shortside(img, target, method):
    ow, oh = img.size
    ss, ls = min(ow, oh), max(ow, oh)
    if ss == target:
        return img
    ls = int(target * ls / ss)
    nw, nh = (ss, ls) if ow == ss else (ls, ss)
    return img.resize((nw, nh), method)


def apply_resize(opt, img: Image.Image, *, method=Image.BICUBIC):
    """The DETERMINISTIC stage of apply_transform (no TransformParams
    input): resize / scale_width / scale_shortside / none-rounding /
    fixed. Split out so loaders can cache its result across epochs — only
    the crop/flip/jitter stages draw randomness."""
    mode = opt.preprocess_mode
    if 'resize' in mode:
        # identity resize is exact under any PIL filter (the sample grid
        # aligns with pixel centers) — skip it: ~1.4ms/item at 256^2,
        # which matters for feeding the device from the 1-core host when
        # the data is staged at load_size already
        if img.size != (opt.load_size, opt.load_size):
            img = img.resize((opt.load_size, opt.load_size), method)
    elif 'scale_width' in mode:
        img = _scale_width(img, opt.load_size, method)
    elif 'scale_shortside' in mode:
        img = _scale_shortside(img, opt.load_size, method)

    if mode == 'none':
        base = 32
        ow, oh = img.size
        w, h = int(round(ow / base) * base), int(round(oh / base) * base)
        if (w, h) != (ow, oh):
            img = img.resize((w, h), method)

    if mode == 'fixed':
        w = opt.crop_size
        h = round(opt.crop_size / opt.aspect_ratio)
        img = img.resize((w, h), method)
    return img


def apply_crop_flip(opt, img: Image.Image, params: TransformParams, *,
                    is_train: bool | None = None):
    """The RANDOM stage: crop at params.crop_pos, then train-time flip.
    (No mode both crops and none/fixed-resizes, so running the crop after
    apply_resize is order-equivalent to the original fused transform.)"""
    mode = opt.preprocess_mode
    if 'crop' in mode:
        x, y = params.crop_pos
        img = img.crop((x, y, x + opt.crop_size, y + opt.crop_size))
    is_train = opt.isTrain if is_train is None else is_train
    if is_train and not getattr(opt, 'no_flip', True) and params.flip:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


def crop_flip_array(opt, arr: np.ndarray, params: TransformParams, *,
                    is_train: bool | None = None) -> np.ndarray:
    """apply_crop_flip on a decoded HWC uint8 array (the cached-decode
    path): numpy slicing instead of PIL ops — same pixels."""
    mode = opt.preprocess_mode
    if 'crop' in mode:
        x, y = params.crop_pos
        cs = opt.crop_size
        sub = arr[y:y + cs, x:x + cs]
        if sub.shape[:2] != (cs, cs):
            # PIL .crop zero-pads beyond the image bounds (reachable when
            # load_size < crop_size); match it
            out = np.zeros((cs, cs) + arr.shape[2:], arr.dtype)
            out[:sub.shape[0], :sub.shape[1]] = sub
            sub = out
        arr = sub
    is_train = opt.isTrain if is_train is None else is_train
    if is_train and not getattr(opt, 'no_flip', True) and params.flip:
        arr = arr[:, ::-1]
    return np.ascontiguousarray(arr)


def apply_transform(opt, img: Image.Image, params: TransformParams, *,
                    method=Image.BICUBIC, is_train: bool | None = None):
    return apply_crop_flip(opt, apply_resize(opt, img, method=method),
                           params, is_train=is_train)


def color_jitter(img: Image.Image, jitter) -> Image.Image:
    """torchvision-style ColorJitter on an RGB PIL image.

    jitter = (order, (brightness, contrast, saturation, hue)): the first
    three are PIL ImageEnhance factors (1.0 = identity, matching
    torchvision's blend formulation); hue is a fraction of the hue circle
    in [-0.5, 0.5]. Applied photometrically only — callers keep it OFF the
    sketch/edge channels (a jittered binary edge map would be corrupt)."""
    if jitter is None:
        return img
    from PIL import ImageEnhance
    order, (b, c, s, hue) = jitter
    for t in order:
        if t == 0:
            img = ImageEnhance.Brightness(img).enhance(b)
        elif t == 1:
            img = ImageEnhance.Contrast(img).enhance(c)
        elif t == 2:
            img = ImageEnhance.Color(img).enhance(s)
        elif hue != 0.0:
            h, sat, v = img.convert("HSV").split()
            arr = np.asarray(h, dtype=np.int16)
            arr = ((arr + int(round(hue * 255))) % 256).astype(np.uint8)
            img = Image.merge(
                "HSV", (Image.fromarray(arr, "L"), sat, v)).convert("RGB")
    return img


def image_to_array(img: Image.Image, normalize: bool = True) -> np.ndarray:
    """PIL -> float32 HWC array; normalize maps [0,255] -> [-1,1]
    (ToTensor + Normalize(0.5, 0.5))."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if normalize:
        arr = (arr - 0.5) / 0.5
    return arr


def binarize_sketch(img: Image.Image, size_wh=None) -> np.ndarray:
    """Grayscale sketch -> {0,1} float32 HW1, resized to the image's size
    first (testimage_dataset.py:99-103)."""
    if size_wh is not None and img.size != size_wh:
        img = img.resize(size_wh)
    arr = np.asarray(img.convert("L"), dtype=np.float32)
    return (arr > 0).astype(np.float32)[:, :, None]
