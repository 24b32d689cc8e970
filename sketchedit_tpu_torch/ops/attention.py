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

``splitcam_attention`` covers the rest of the reference's configuration
space (``SplitCAMConfig``), as dense torch: no kernel serves it, in the JAX
package either (``is_th=False`` gates per (query, key) pair, which the
kernels' per-key ``keep`` cannot express).
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
    Defaults are the released generator's (``is_released``), which the
    kernels serve; ``splitcam_attention`` takes any of them."""
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


def _pad_replicate(x, pd: int):
    return F.pad(x, (pd, pd, pd, pd), mode="replicate") if pd else x


def _fuse_diag(s, fuse_k: int):
    """One fuse pass over the (B, P, N) plane: a sum over the flat-index
    diagonal offsets -1, 0, +1, zero padded (the reference's identity
    kernel with padding 1, so only fuse_k = 3 keeps the shape)."""
    if fuse_k != 3:
        raise ValueError("the reference's fuse pads by 1: only fuse_k=3 works")
    sp = F.pad(s, (1, 1, 1, 1))
    return sp[:, :-2, :-2] + sp[:, 1:-1, 1:-1] + sp[:, 2:, 2:]


def _fuse(sim_pn, p_hw, n_hw, fuse_k: int):
    """Two-pass fuse smoothing: along the row-major diagonal, then again
    with both the patch grid and the position grid transposed."""
    B, P, N = sim_pn.shape
    (ph, pw), (nh, nw) = p_hw, n_hw
    s = _fuse_diag(sim_pn, fuse_k)
    s = s.reshape(B, ph, pw, nh, nw).permute(0, 2, 1, 4, 3).reshape(B, P, N)
    s = _fuse_diag(s, fuse_k)
    return s.reshape(B, pw, ph, nw, nh).permute(0, 2, 1, 4, 3).reshape(
        B, P, N)


def _grid(x, k: int, s: int):
    """The (rows, cols) of the k x k patch grid of a (B, C, H, W) map at
    stride s."""
    return ((x.shape[2] - k) // s + 1, (x.shape[3] - k) // s + 1)


def splitcam_attention(f, b, mask, config: SplitCAMConfig = SplitCAMConfig(),
                       *, return_weights: bool = False,
                       return_recon: bool = False):
    """P1 + P2 at any configuration the reference can build (counterpart of
    ``sketchedit_tpu/ops/attention.py::splitcam_attention``), NCHW.

    f, b: (B, C, H, W) foreground and background features; mask:
    (B, 1, H, W), 1 = hole. Computes in float32 and returns ``out`` in f's
    dtype; optionally the float32 (B, N, P) weights and the (B, 1, H, W)
    hole reconstruction, normalized by the overlap count (the output is
    not). The norm_type 1 norm is taken over the unpadded map before the
    replicate pad; norm_type 2 normalizes each (patch, channel) over its
    k x k pixels; ``mk`` zeroes the hole pixels of the value patches;
    ``nn_hard`` takes the one-hot of the first maximum, with no gradient.
    """
    cfg = config
    B, C, H, W = b.shape
    k, sq, sk, pd = cfg.bkg_patch_size, cfg.stride, cfg.ufstride, cfg.pd
    in_dtype = f.dtype
    f, b, mask = f.float(), b.float(), mask.float()
    valid = 1.0 - mask

    bn = b / background_norm(b) if cfg.norm_type == 1 else b
    bp = _pad_replicate(bn, pd)
    p_hw = _grid(bp, k, sk)
    P = p_hw[0] * p_hw[1]
    K = extract_patches(bp, k, sk)                            # (B, P, C*k*k)
    if cfg.norm_type == 2:
        Kc = K.reshape(B, P, C, k * k)
        K = (Kc / torch.sqrt(torch.sum(Kc * Kc, dim=3, keepdim=True)
                             + 1e-8)).reshape(B, P, C * k * k)
    valid_p = _pad_replicate(valid, pd)
    mmk = patch_valid_ratio(valid_p, k, sk)                   # (B, P)

    fp = _pad_replicate(f, pd)
    n_hw = _grid(fp, k, sq)
    Q = extract_patches(fp, k, sq)                            # (B, N, C*k*k)
    sim = torch.bmm(Q, K.transpose(1, 2))
    if cfg.is_fuse:
        sim = _fuse(sim.transpose(1, 2), p_hw, n_hw,
                    cfg.fuse_k).transpose(1, 2)

    if cfg.is_th:
        gate = (mmk > cfg.th).float()[:, None, :]
    else:
        # keep key p for query n where it is strictly more valid and the
        # query patch is partly valid, or where it is fully valid
        mmp = patch_valid_ratio(valid_p, k, sq)               # (B, N)
        gate = (((mmk[:, None, :] > mmp[:, :, None])
                 & (mmp > cfg.th)[:, :, None])
                | (mmk == 1.0)[:, None, :]).float()
    w = torch.softmax(sim * gate * cfg.softmax_scale, dim=-1)
    if cfg.nn_hard:
        w = F.one_hot(torch.argmax(w, dim=-1), P).to(w.dtype).detach()

    V = extract_patches(_pad_replicate(b, pd), k, sk)
    mk_patches = extract_patches(_pad_replicate(mask, pd), k, sk)  # (B,P,k*k)
    if cfg.mk:
        V = (V.reshape(B, P, C, k * k)
             * (1.0 - mk_patches)[:, :, None, :]).reshape(B, P, C * k * k)

    Hp, Wp = H + 2 * pd, W + 2 * pd

    def fold(patches):
        out = fold_patches(patches, (Hp, Wp), k, sq)
        return out[:, :, pd:Hp - pd, pd:Wp - pd]

    results = [fold(torch.bmm(w, V)).to(in_dtype)]
    if return_weights:
        results.append(w)
    if return_recon:
        overlap = fold(mk_patches.new_ones((1, Q.shape[1], k * k)))
        results.append(fold(torch.bmm(w, mk_patches)) / overlap)
    return results[0] if len(results) == 1 else tuple(results)
