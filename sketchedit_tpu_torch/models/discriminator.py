"""netD, the spectral-norm PatchGAN discriminator (counterpart of
``sketchedit_tpu/models/discriminator.py``).

Input ``cat([image(3), line(1), cc(3)])``, six 5x5/stride-2 leaky-relu convs
(slope 0.2, as SN-PatchGAN) with spectral normalization, patch logits out.
The spectral norm is functional: one power-iteration step per call from the
``u`` buffer of each layer. ``u`` changes only where the caller asks for the
new vectors (``update_sn``) and writes them back with ``load_u_`` — the D
step does, the G step's call to D does not. ``torch.nn.utils.spectral_norm``
is not used: its hook updates ``u`` on every training-mode forward.

State-dict keys: ``dconvN.weight`` (OIHW), ``dconvN.bias``, ``dconvN.u``;
the multiscale variant nests them under ``scaleI.``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from sketchedit_tpu_torch.ops.gated_conv import leaky_conv2d

# (name, cin, cout); all 5x5 stride 2
_SPECS = [
    ("dconv1", 7, 64),
    ("dconv2", 64, 128),
    ("dconv3", 128, 256),
    ("dconv4", 256, 256),
    ("dconv5", 256, 256),
    ("dconv6", 256, 256),
]


def spectral_normalize(weight, u):
    """One power-iteration step on the (cout, fan_in) matrix of ``weight``;
    returns (weight / sigma, new u). Both iteration vectors are detached, so
    only the direct weight term of sigma = u^T W v carries gradient."""
    wm = weight.reshape(weight.shape[0], -1)
    with torch.no_grad():
        v = u @ wm
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u_new = wm @ v
        u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
    sigma = u_new @ (wm @ v)
    return weight / (sigma + 1e-12), u_new


class Discriminator(nn.Module):
    """Single-scale SN-PatchGAN."""

    def __init__(self, *, device=None, dtype=None):
        super().__init__()
        for name, cin, cout in _SPECS:
            conv = nn.Conv2d(cin, cout, 5, stride=2, padding=2, device=device,
                             dtype=dtype)
            conv.register_buffer("u", torch.ones(cout, device=device,
                                                 dtype=dtype))
            self.add_module(name, conv)

    def forward(self, image, line, cc, update_sn: bool = False):
        """Patch logits (B, 256, H/64, W/64) for NCHW inputs; with
        ``update_sn``, (logits, {layer: new u})."""
        x = torch.cat([image, line, cc], dim=1)
        new_u = {}
        for name, _cin, _cout in _SPECS:
            conv = getattr(self, name)
            w_sn, new_u[name] = spectral_normalize(conv.weight, conv.u)
            x = leaky_conv2d(x, w_sn, conv.bias, stride=2,
                             negative_slope=0.2)
        return (x, new_u) if update_sn else x


def _downsample2(x):
    """nn.AvgPool2d(3, 2, padding=1, count_include_pad=False), as SPADE's
    multiscale discriminator pools."""
    return F.avg_pool2d(x, 3, 2, padding=1, count_include_pad=False)


class MultiscaleDiscriminator(nn.Module):
    """``num_d`` independent SN-PatchGANs; scale i sees the inputs pooled
    2^i times. Returns a list of logits, coarsest last."""

    def __init__(self, num_d: int = 2, *, device=None, dtype=None):
        super().__init__()
        for i in range(num_d):
            self.add_module(f"scale{i}", Discriminator(device=device,
                                                       dtype=dtype))

    def forward(self, image, line, cc, update_sn: bool = False):
        logits, new_u = [], {}
        scales = list(self.named_children())
        for i, (name, d) in enumerate(scales):
            out = d(image, line, cc, update_sn=update_sn)
            if update_sn:
                out, u = out
                new_u.update({f"{name}.{k}": v for k, v in u.items()})
            logits.append(out)
            if i + 1 < len(scales):
                image, line, cc = map(_downsample2, (image, line, cc))
        return (logits, new_u) if update_sn else logits


@torch.no_grad()
def load_u_(net: nn.Module, new_u):
    """Write the power-iteration vectors returned by ``update_sn`` back into
    the ``u`` buffers."""
    for name, u in new_u.items():
        net.get_submodule(name).u.copy_(u)


@torch.no_grad()
def init_(net: nn.Module, generator: torch.Generator, *, gain: float = 0.02):
    """xavier-normal weights (gain 0.02), zero biases, u ~ N(0, 1), drawn on
    the CPU from ``generator`` (the JAX package's init distributions)."""
    for conv in net.modules():
        if isinstance(conv, nn.Conv2d):
            cout, cin, kh, kw = conv.weight.shape
            std = gain * math.sqrt(2.0 / ((cin + cout) * kh * kw))
            conv.weight.copy_(torch.randn(conv.weight.shape,
                                          generator=generator) * std)
            conv.bias.zero_()
            conv.u.copy_(torch.randn(cout, generator=generator))
