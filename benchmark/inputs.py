"""Seeded inputs, made on the device in a few large calls.

- ``photo_like``: a stand-in for a photograph (smooth colour fields from a
  bicubic 8x8 upsample, six hard-edged rectangles with sides in
  [H/8, H/2) blended in, mild sensor
  noise), uint8 NHWC;
- ``strokes``: a partial sketch of a few strokes (polylines two pixels
  wide) inside a box of a third of the image, uint8 NHW1 with 255 on a
  stroke;
- ``rectangles``: one rectangle per image with sides in [H/4, H/2), bool
  NHW1, the training mix's inpainting and context masks.

Every function takes its own generator, so one draw does not shift the
next.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _randint(g, lo, hi, shape, device):
    return torch.randint(lo, hi, shape, generator=g, device=device)


def photo_like(g, n: int, size: int, device) -> torch.Tensor:
    low = torch.rand((n, 3, 8, 8), generator=g, device=device) * 255
    img = F.interpolate(low, size=(size, size), mode="bicubic",
                        align_corners=False)
    ys = torch.arange(size, device=device).view(1, 1, size, 1)
    xs = torch.arange(size, device=device).view(1, 1, 1, size)
    for _ in range(6):
        h, w = _randint(g, size // 8, size // 2, (2, n, 1, 1, 1), device)
        y0, x0 = (torch.rand((2, n, 1, 1, 1), generator=g, device=device)
                  * (size - torch.stack([h, w]))).long()
        colour = torch.rand((n, 3, 1, 1), generator=g, device=device) * 127
        box = (ys >= y0) & (ys < y0 + h) & (xs >= x0) & (xs < x0 + w)
        img = torch.where(box, img * 0.5 + colour, img)
    img = img + torch.randn(img.shape, generator=g, device=device) * 4
    return img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def strokes(g, n: int, size: int, device, lo: int = 3, hi: int = 6,
            points: int = 4) -> torch.Tensor:
    """``lo`` to ``hi`` strokes per image, each a polyline through
    ``points`` points drawn in one box of side size/3 per image."""
    side = size // 3
    corner = _uniform(g, (n, 1, 1, 2), 0, size - side, device)
    pts = corner + _uniform(g, (n, hi, points, 2), 0, side, device)
    count = _randint(g, lo, hi + 1, (n, 1), device)
    samples = 2 * side
    t = torch.linspace(0, 1, samples, device=device).view(1, 1, 1, -1, 1)
    seg = pts[:, :, :-1, None, :] * (1 - t) + pts[:, :, 1:, None, :] * t
    yx = seg.round().long().clamp(0, size - 2)           # (n, hi, seg, s, 2)
    drawn = (torch.arange(hi, device=device).view(1, hi) < count)
    img = torch.zeros((n, size, size), dtype=torch.uint8, device=device)
    flat = img.view(-1)
    base = (torch.arange(n, device=device) * size * size).view(n, 1, 1, 1)
    idx = base + yx[..., 0] * size + yx[..., 1]
    idx = idx[drawn]                                     # (strokes, seg, s)
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        flat[(idx + dy * size + dx).reshape(-1)] = 255
    return img.unsqueeze(-1)


def rectangles(g, n: int, size: int, device) -> torch.Tensor:
    h, w = _randint(g, size // 4, size // 2, (2, n, 1, 1), device)
    y0 = (torch.rand((n, 1, 1), generator=g, device=device)
          * (size - h)).long()
    x0 = (torch.rand((n, 1, 1), generator=g, device=device)
          * (size - w)).long()
    ys = torch.arange(size, device=device).view(1, size, 1)
    xs = torch.arange(size, device=device).view(1, 1, size)
    box = (ys >= y0) & (ys < y0 + h) & (xs >= x0) & (xs < x0 + w)
    return box.unsqueeze(-1)
