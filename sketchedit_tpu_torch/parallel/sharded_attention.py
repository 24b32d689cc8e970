"""Contextual attention with its query-patch axis split over devices
(counterpart of ``sketchedit_tpu/parallel/sharded_attention.py``).

The patch count grows with the square of the resolution (961 patches at
256^2, 3969 at 512^2, ~16k at 1024^2). Every device holds the whole key
and value bank (P x D, a few MB) and computes the softmax and the
reconstruction for its slice of query patches through the attention
kernel; no device exchanges anything with another until the slices come
back to the caller's device to be folded. On the CPU each slice takes the
kernel's plain version.

Under autograd the copies and slices route the gradients back: each
shard's dQ lands on its rows of the query tensor, and its partial dK and
dV (and dkscale) are summed over the shards. The forward is always the
default kernel: the shared-tensor kernel needs queries that are the values
(a slice is not), and the D-split has no backward.
"""

from __future__ import annotations

import torch

from sketchedit_tpu_torch.ops.attention import (
    background_norm, extract_patches, fold_patches, keep_gate)
from sketchedit_tpu_torch.ops.attention_cuda import (
    attention_core_differentiable)


def contextual_attention_sharded(f, b, mask, devices, *, patch_size: int = 4,
                                 stride: int = 2, softmax_scale: float = 10.0,
                                 th: float = 0.1):
    """Same result as ``ops.attention.contextual_attention`` (NCHW in and
    out, mask (B, 1, H, W) at feature resolution, 1 = hole), with the query
    patches split into ``len(devices)`` slices, one per device
    (``torch.tensor_split``: the slices may differ by one patch). K, V,
    keep and kscale are formed once, in float32, on the caller's device and
    copied to each device; the result is cast to f's dtype."""
    B, C, H, W = b.shape
    k, s = patch_size, stride
    b32 = b.float()
    kscale = (1.0 / background_norm(b32)).reshape(B, C, 1).expand(
        B, C, k * k).reshape(B, C * k * k).contiguous()
    V = extract_patches(b32, k, s).contiguous()
    Q = V if f is b else extract_patches(f.float(), k, s).contiguous()
    keep = keep_gate(mask, k, s, th)

    outs = []
    for q, dev in zip(torch.tensor_split(Q, len(devices), dim=1), devices):
        # a slice of the patch axis is contiguous only at B = 1
        q = q.to(dev).contiguous()
        v, kp, ks = (t.to(dev) for t in (V, keep, kscale))
        outs.append(attention_core_differentiable(q, v, v, kp, softmax_scale,
                                                  kscale=ks))
    out = torch.cat([o.to(b.device) for o in outs], dim=1)
    return fold_patches(out, (H, W), k, s).to(f.dtype)
