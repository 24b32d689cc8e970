"""The plain reference of one served edit (the released ``edit_u8``).

    soft, _ = netM(image, sketch)
    hard = soft > 0.5
    _, fake = netG(image, image, hard, hard, sketch)
    composed = fake * soft + image * (1 - soft)

uint8 NHWC in. ``soft_mask`` gives netM's mask and ``composite`` netG's
fill composited under a given hard and soft mask, both in uint8 units
(0..255) and unrounded, so that a served uint8 answer can be held to them;
``edit`` runs the whole edit and rounds as a server does (half to even).
"""

from __future__ import annotations

import torch

from benchmark.reference import nets
from benchmark.reference.precision import FLOAT32, plain_float32


def _nchw(image_u8, sketch_u8):
    if image_u8.shape[1] % 8 or image_u8.shape[2] % 8:
        raise ValueError("the reference edits sizes on the /8 grid only")
    image = image_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    sketch = (sketch_u8.permute(0, 3, 1, 2) > 0).float()
    return image, sketch


@torch.no_grad()
def soft_mask(weights, image_u8, sketch_u8, q=FLOAT32):
    """netM's soft mask, (B, H, W, 1) in 0..255."""
    with plain_float32():
        image, sketch = _nchw(image_u8, sketch_u8)
        soft, _ = nets.net_m(weights["M"], image, sketch, q)
    return (soft.clamp(0, 1) * 255.0).permute(0, 2, 3, 1)


@torch.no_grad()
def composite(weights, image_u8, sketch_u8, hard, soft, q=FLOAT32):
    """netG's fill under ``hard`` (B, H, W, 1) in {0, 1}, composited with
    ``soft`` (B, H, W, 1) in [0, 1]: (B, H, W, 3) in 0..255."""
    with plain_float32():
        image, sketch = _nchw(image_u8, sketch_u8)
        hard = hard.permute(0, 3, 1, 2).float()
        soft = soft.permute(0, 3, 1, 2).float()
        _, fake = nets.net_g(weights["G"], image, image, hard, hard, sketch, q)
        composed = fake * soft + image * (1.0 - soft)
    return ((composed.clamp(-1, 1) + 1.0) * 127.5).permute(0, 2, 3, 1)


@torch.no_grad()
def edit(weights, image_u8, sketch_u8, q=FLOAT32):
    """The whole edit as a server sends it: (composite uint8, mask uint8,
    hard mask (B, H, W, 1) in {0, 1})."""
    with plain_float32():
        image, sketch = _nchw(image_u8, sketch_u8)
        soft, _ = nets.net_m(weights["M"], image, sketch, q)
        hard = (soft > 0.5).float()
        _, fake = nets.net_g(weights["G"], image, image, hard, hard, sketch, q)
        composed = fake * soft + image * (1.0 - soft)
    composed = torch.round((composed.clamp(-1, 1) + 1.0) * 127.5)
    mask = torch.round(soft.clamp(0, 1) * 255.0)
    return tuple(t.permute(0, 2, 3, 1) for t in (
        composed.to(torch.uint8), mask.to(torch.uint8), hard))
