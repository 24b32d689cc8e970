"""The arithmetic the plain reference runs in.

``FLOAT32`` is the reference: float32 with TF32 off (``plain_float32``
turns cuDNN's and cuBLAS's TF32 off for as long as it is entered).
``FP8`` is the control: the same code, with both operands of every
convolution and attention product rounded to float8 e4m3 under a
per-tensor scale (the tensor's largest magnitude at e4m3's largest finite
value, 448), the step below the configurations' bfloat16; sums and every
other operation stay float32. ``BF16`` rounds the same operands to
bfloat16: how far it lands from ``FLOAT32`` is the unit in which the
checks state the program's distance.
"""

from __future__ import annotations

import contextlib

import torch


class Precision:
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Fp8(Precision):
    MAX = 448.0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        scale = x.detach().abs().amax().clamp(min=1e-30) / self.MAX
        r = (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        # the rounding passes gradients straight through
        return x + (r - x).detach()


class Bf16(Precision):
    """Both operands rounded to bfloat16: the configurations' own
    precision in plain code."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


FLOAT32 = Precision()
FP8 = Fp8()
BF16 = Bf16()


@contextlib.contextmanager
def plain_float32():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
