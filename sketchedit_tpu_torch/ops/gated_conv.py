"""Gated convolution primitives, NCHW (counterpart of
``sketchedit_tpu/ops/gated_conv.py``).

- ``conv2d``: conv with padding ``int(rate*(k-1)/2)`` and dilation ``rate``.
- ``gated_conv2d``: unless the declared output width is 3 or the activation
  is None, the output is split in half along channels and combined as
  ``act(a) * sigmoid(g)``; the effective width is half the declared cout.
- ``gated_deconv2d``: nearest x2 upsample, then a 3x3 gated conv.
- ``leaky_conv2d``: conv with padding ``int((k-1)/2)``, then leaky-relu (the
  reference ``dis_conv``, used by the discriminator).

``GatedConv2d`` is an ``nn.Conv2d`` (as the reference's ``gen_conv`` is), so
its state-dict keys are ``<layer>.weight`` (OIHW) and ``<layer>.bias``.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from sketchedit_tpu_torch.ops.image import nearest_upsample2x

_ACTIVATIONS = {"elu": F.elu, "relu": F.relu}


def conv2d(x, weight, bias, *, stride: int = 1, rate: int = 1):
    k = weight.shape[-1]
    p = int(rate * (k - 1) / 2)
    return F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), stride=stride,
                    padding=p, dilation=rate)


def _gate(y, cout: int, activation: str | None):
    if cout == 3 or activation is None:
        return y
    a, g = y.chunk(2, dim=1)
    return _ACTIVATIONS[activation](a) * torch.sigmoid(g)


def gated_conv2d(x, weight, bias, *, stride: int = 1, rate: int = 1,
                 activation: str | None = "elu"):
    y = conv2d(x, weight, bias, stride=stride, rate=rate)
    return _gate(y, weight.shape[0], activation)


def gated_deconv2d(x, weight, bias, *, activation: str | None = "elu"):
    """The reference's plain form: upsample, then conv. The JAX package's
    single lhs-dilated conv is the same sum in another order."""
    if weight.shape[-2:] != (3, 3):
        raise ValueError("gated_deconv2d is always 3x3")
    return gated_conv2d(nearest_upsample2x(x), weight, bias,
                        activation=activation)


def leaky_conv2d(x, weight, bias, *, stride: int = 2,
                 negative_slope: float = 0.01):
    """Conv + leaky-relu; the reference's slope is F.leaky_relu's 0.01."""
    y = F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), stride=stride,
                 padding=int((weight.shape[-1] - 1) / 2))
    return F.leaky_relu(y, negative_slope)


class GatedConv2d(nn.Conv2d):
    """One layer of a spec table: (cin, cout, ksize, stride, rate,
    activation, deconv)."""

    def __init__(self, cin: int, cout: int, ksize: int, stride: int = 1,
                 rate: int = 1, activation: str | None = "elu",
                 deconv: bool = False, *, device=None, dtype=None):
        super().__init__(cin, cout, ksize, stride=stride,
                         padding=int(rate * (ksize - 1) / 2), dilation=rate,
                         device=device, dtype=dtype)
        if activation is not None and activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.rate = rate
        self.activation = activation
        self.deconv = deconv

    def forward(self, x):
        if self.deconv:
            return gated_deconv2d(x, self.weight, self.bias,
                                  activation=self.activation)
        return gated_conv2d(x, self.weight, self.bias, stride=self.stride[0],
                            rate=self.rate, activation=self.activation)


@torch.no_grad()
def init_conv_(conv: nn.Conv2d, generator: torch.Generator, *,
               init_type: str = "xavier", gain: float = 0.02):
    """Re-initialize one conv in place, drawing from ``generator`` on the
    CPU and copying to the conv's device, so a seed gives the same weights
    on every device. Same distributions as the JAX ``init_conv_params``;
    biases are zero except for 'none' (torch's Conv2d default)."""
    cout, cin, kh, kw = conv.weight.shape
    fan_in, fan_out = cin * kh * kw, cout * kh * kw
    shape = conv.weight.shape
    bias = torch.zeros(cout)
    if init_type == "xavier":
        w = torch.randn(shape, generator=generator) * (
            gain * math.sqrt(2.0 / (fan_in + fan_out)))
    elif init_type == "xavier_uniform":
        a = math.sqrt(6.0 / (fan_in + fan_out))
        w = (torch.rand(shape, generator=generator) * 2 - 1) * a
    elif init_type == "kaiming":
        w = torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)
    elif init_type == "normal":
        w = torch.randn(shape, generator=generator) * gain
    elif init_type == "orthogonal":
        flat = torch.randn((cout, fan_in), generator=generator)
        q, r = torch.linalg.qr(flat.T if fan_in >= cout else flat)
        q = q * torch.sign(torch.diagonal(r))
        w = gain * (q.T if fan_in >= cout else q).reshape(shape)
    elif init_type == "none":
        bound_w = math.sqrt(6.0 / ((1 + 5) * fan_in))
        w = (torch.rand(shape, generator=generator) * 2 - 1) * bound_w
        bound_b = 1.0 / math.sqrt(fan_in)
        bias = (torch.rand(cout, generator=generator) * 2 - 1) * bound_b
    else:
        raise NotImplementedError(f"init [{init_type}] not implemented")
    conv.weight.copy_(w)
    conv.bias.copy_(bias)
