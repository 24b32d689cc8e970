"""Contextual attention ("splitcam") as two batched matmuls, NCHW.

Counterpart of ``sketchedit_tpu/ops/attention.py`` at the configuration the
released generator uses: patch 4x4, stride 2, softmax scale 10, keep rule
``valid_ratio > 0.1``. The reference's quirks are kept:

* the background is normalized by its global per-(batch, channel) spatial
  L2 norm, with ``+1e-8`` inside the square root, not per patch;
* a gated patch has its similarity multiplied by 0, so it still adds
  exp(0) = 1 to the softmax denominator (not -inf masking);
* the overlap-add fold is not normalized by the overlap count
  (``F.fold`` sums, which matches).

This dense module is the plain version of the attention path and runs on
any device; ``attention_cuda.contextual_attention_fused`` is its kernel
counterpart. Patch vectors are in ``F.unfold`` order (c, ky, kx), a fixed
permutation of the JAX package's (ky, kx, c); inner products and the fold
do not depend on it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


def extract_patches(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """(B, C, H, W) -> (B, L, C*k*k): k x k patches at stride s, VALID."""
    return F.unfold(x, k, stride=s).transpose(1, 2)


def fold_patches(patches: torch.Tensor, out_hw, k: int, s: int):
    """Overlap-ADD (B, L, C*k*k) patches back to (B, C, H, W)."""
    return F.fold(patches.transpose(1, 2), tuple(out_hw), k, stride=s)


def patch_valid_ratio(valid: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Mean of a (B, 1, H, W) validity map over each k x k patch -> (B, L)."""
    v = F.avg_pool2d(valid.float(), k, s)
    return v.reshape(v.shape[0], -1)


def keep_gate(mask: torch.Tensor, k: int, s: int, th: float):
    """(B, L) float gate: 1 where the patch's valid ratio exceeds ``th``."""
    return (patch_valid_ratio(1.0 - mask.float(), k, s) > th).float()


def background_norm(b: torch.Tensor) -> torch.Tensor:
    """(B, C, 1, 1) global per-(batch, channel) L2 norm of ``b`` in f32."""
    bf = b.float()
    return torch.sqrt(torch.sum(bf * bf, dim=(2, 3), keepdim=True) + 1e-8)


def contextual_attention(f, b, mask, *, patch_size: int = 4, stride: int = 2,
                         softmax_scale: float = 10.0, th: float = 0.1):
    """f attends over the patches of b, gated by the hole mask.

    f, b: (B, C, H, W); mask: (B, 1, H, W) at feature resolution, 1 = hole.
    Computes in f32 and returns the input dtype.
    """
    B, C, H, W = b.shape
    k, s = patch_size, stride
    in_dtype = f.dtype
    f32, b32 = f.float(), b.float()

    K = extract_patches(b32 / background_norm(b32), k, s)
    V = extract_patches(b32, k, s)
    Q = extract_patches(f32, k, s)
    keep = keep_gate(mask, k, s, th)

    logits = torch.bmm(Q, K.transpose(1, 2)) * keep[:, None, :] * softmax_scale
    w = torch.softmax(logits, dim=-1)
    return fold_patches(torch.bmm(w, V), (H, W), k, s).to(in_dtype)


@dataclass(frozen=True)
class SplitCAMConfig:
    """Constructor surface of the reference's ReduceContextAttentionP1/P2.
    Defaults are the released generator's; the port implements only those
    (``is_released``)."""
    bkg_patch_size: int = 4
    stride: int = 2
    ufstride: int = 2
    softmax_scale: float = 10.0
    nn_hard: bool = False
    pd: int = 0
    fuse_k: int = 3
    is_fuse: bool = False
    th: float = 0.1
    norm_type: int = 1
    is_th: bool = True
    mk: bool = False

    @property
    def is_released(self) -> bool:
        return self == SplitCAMConfig()
