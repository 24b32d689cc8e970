"""Training losses (counterpart of ``sketchedit_tpu/train/losses.py``).

``gan_loss`` in the hinge, ls, original and w modes (a list of logits, from
the multiscale discriminator, averages the per-scale losses), plain L1,
the saturation-safe mask BCE, and a VGG19 perceptual loss whose weights
come from ``SKETCHEDIT_VGG_WEIGHTS`` (an .npz of HWIO ``conv_i_w`` and
``conv_i_b``, as the JAX package reads it). Tensors are NCHW.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(a, b):
    return (a - b).abs().mean()


def mask_bce_loss(soft_mask, target):
    """Binary cross-entropy on an already-sigmoided mask. The floors keep
    the log finite; the trainer computes the sigmoid in float32 (see
    ``MDGenerator.forward``'s ``mask_dtype``)."""
    m = soft_mask.float()
    t = target.float()
    eps = 1e-20
    return -(t * torch.log(torch.clamp(m, min=eps))
             + (1.0 - t) * torch.log(torch.clamp(1.0 - m, min=eps))).mean()


def gan_loss(pred, target_is_real: bool, *, mode: str = "hinge",
             for_discriminator: bool = True):
    """Adversarial objectives on patch logits; a list averages per scale."""
    if isinstance(pred, (list, tuple)):
        per = [gan_loss(p, target_is_real, mode=mode,
                        for_discriminator=for_discriminator) for p in pred]
        return sum(per) / len(per)
    if mode == "hinge":
        if for_discriminator:
            if target_is_real:
                return F.relu(1.0 - pred).mean()
            return F.relu(1.0 + pred).mean()
        if not target_is_real:
            raise ValueError("the generator hinge loss takes fake "
                             "predictions as real")
        return -pred.mean()
    if mode == "ls":
        target = 1.0 if target_is_real else 0.0
        return ((pred - target) ** 2).mean()
    if mode == "original":
        target = 1.0 if target_is_real else 0.0
        return (torch.clamp(pred, min=0) - pred * target
                + torch.log1p(torch.exp(-pred.abs()))).mean()
    if mode == "w":
        return -pred.mean() if target_is_real else pred.mean()
    raise ValueError(f"unknown gan_mode {mode!r}")


# --- VGG19 perceptual loss ------------------------------------------------

# torchvision .features indices ending the 5 taps (relu1_1 ... relu5_1)
_VGG_SLICES = (2, 7, 12, 21, 30)
_VGG_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
            512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
_N_CONVS = sum(1 for c in _VGG_CFG if c != "M")


def vgg_params_from_arrays(arrays, device=None):
    """[(HWIO weight, bias)] numpy pairs -> [(OIHW weight, bias)] tensors."""
    return [(torch.from_numpy(np.ascontiguousarray(
                np.asarray(w, np.float32).transpose(3, 2, 0, 1))).to(device),
             torch.from_numpy(np.asarray(b, np.float32).copy()).to(device))
            for w, b in arrays]


def load_vgg_params(path: str | None = None, device=None):
    """VGG19 conv weights from an .npz of {'conv_i_w', 'conv_i_b'}, or None
    when no file is given or found."""
    path = path or os.environ.get("SKETCHEDIT_VGG_WEIGHTS")
    if not path or not os.path.exists(path):
        return None
    with np.load(path) as data:
        arrays = []
        while f"conv_{len(arrays)}_w" in data:
            i = len(arrays)
            arrays.append((data[f"conv_{i}_w"], data[f"conv_{i}_b"]))
    if len(arrays) != _N_CONVS:
        raise ValueError(f"{path} has {len(arrays)} conv_i_w/b pairs; VGG19 "
                         f"needs {_N_CONVS} (see scripts/convert_vgg19.py)")
    return vgg_params_from_arrays(arrays, device)


def vgg_features(params, x, imagenet_norm: bool = True):
    """x in [-1, 1], NCHW -> the feature maps at the 5 taps. imagenet_norm
    remaps to the normalization VGG19 was trained with (the JAX package's
    default); False feeds [-1, 1] straight in, as SPADE does."""
    if imagenet_norm:
        mean = x.new_tensor([0.485, 0.456, 0.406]).reshape(1, 3, 1, 1)
        std = x.new_tensor([0.229, 0.224, 0.225]).reshape(1, 3, 1, 1)
        h = ((x + 1.0) / 2.0 - mean) / std
    else:
        h = x
    feats = []
    layer_idx = 0
    conv_i = 0
    for c in _VGG_CFG:
        if c == "M":
            h = F.max_pool2d(h, 2, 2)
            layer_idx += 1
        else:
            w, b = params[conv_i]
            h = F.relu(F.conv2d(h, w.to(h.dtype), b.to(h.dtype), padding=1))
            conv_i += 1
            layer_idx += 2
        if layer_idx in _VGG_SLICES:
            feats.append(h)
    return feats


def vgg_loss(vgg_params, x, y, imagenet_norm: bool = True):
    fx = vgg_features(vgg_params, x, imagenet_norm)
    with torch.no_grad():
        fy = vgg_features(vgg_params, y, imagenet_norm)
    return sum(w * l1_loss(a, b) for w, a, b in zip(_VGG_WEIGHTS, fx, fy))
