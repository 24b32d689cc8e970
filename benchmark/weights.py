"""Seeded random weights for the published nets, made on the device.

Each net's weights come from one draw of a generator on the device, seeded
from the run's seed and the net's name, in float32:

- netM and netG: He-normal (std sqrt(2 / fan_in)), zero biases, then
  scaled by the configuration's gains (1.6 for netM, 1.4 for netG): netM's
  soft mask spreads over (0.1, 0.9) on photo-like inputs and netG's fill
  is no constant, while rounding is not yet amplified through the nets
  (at 1.8 and 1.5 a bfloat16 run reads several times further from the
  float32 one);
- netD: Xavier-normal with gain 0.02, zero biases, u ~ N(0, 1);
- VGG19: He-normal, zero biases (the loss costs what real weights cost).

The same seed on the same device gives the same tensors, so the reference
makes them again after the measured window instead of keeping a copy.
"""

from __future__ import annotations

import hashlib
import math

import torch

from benchmark.reference import nets


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed (any whole number)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, tag))
    return g


def _layers(net: str):
    """[(name, (cout, cin, k, k))] of a net's convolutions."""
    if net == "M":
        return [(s[0], (s[2], s[1], s[3], s[3])) for s in nets.M_LAYERS]
    if net == "G":
        return [(s[0], (s[2], s[1], s[3], s[3])) for s in nets.G_LAYERS]
    if net == "D":
        return [(n, (cout, cin, 5, 5)) for n, cin, cout in nets.D_LAYERS]
    raise ValueError(net)


def _std(shape, net: str) -> float:
    cout, cin, kh, kw = shape
    if net == "D":
        return 0.02 * math.sqrt(2.0 / ((cin + cout) * kh * kw))
    return math.sqrt(2.0 / (cin * kh * kw))


def make(net: str, seed: int, device, gains: dict) -> dict:
    """{'<layer>.weight', '<layer>.bias' (and '<layer>.u' for netD)} of one
    net, float32 on ``device``."""
    layers = _layers(net)
    sizes = [math.prod(shape) for _, shape in layers]
    extra = sum(shape[0] for _, shape in layers) if net == "D" else 0
    flat = torch.randn(sum(sizes) + extra, generator=generator(
        seed, f"weights.{net}", device), device=device)
    out, off = {}, 0
    gain = gains.get(net, 1.0)
    for (name, shape), n in zip(layers, sizes):
        out[f"{name}.weight"] = flat[off:off + n].view(shape) * (
            _std(shape, net) * gain)
        out[f"{name}.bias"] = torch.zeros(shape[0], device=device)
        off += n
    if net == "D":
        for name, shape in layers:
            out[f"{name}.u"] = flat[off:off + shape[0]].clone()
            off += shape[0]
    return out


def vgg(seed: int, device) -> list:
    """VGG19's 16 convolutions as [(OIHW weight, bias)]."""
    shapes, cin = [], 3
    for c in [64, 64, 128, 128] + [256] * 4 + [512] * 8:
        shapes.append((c, cin, 3, 3))
        cin = c
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights.vgg",
                                                       device), device=device)
    out, off = [], 0
    for s, n in zip(shapes, sizes):
        out.append((flat[off:off + n].view(s) * math.sqrt(2.0 / (s[1] * 9)),
                    torch.zeros(s[0], device=device)))
        off += n
    return out
