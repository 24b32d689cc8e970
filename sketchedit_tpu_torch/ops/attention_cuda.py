"""Fused contextual-attention forward on the GPU (counterpart of
``sketchedit_tpu/ops/attention_pallas.py``).

``attention_core`` computes ``softmax((Q K^T) * keep * scale) V`` with the
splitcam gating quirk (a gated key gets logit 0). A CUDA tensor launches the
hand-written kernel ``csrc/contextual_attention_fwd.cu``, which replaces
``attention_pallas.py::_attn_kernel``, or the call raises; a CPU tensor takes
``attention_core_reference``, the plain PyTorch version. Nothing falls back
from one to the other.

The kernel keeps the whole (TQ, D) float32 accumulator of a query tile in
shared memory and streams K and V tiles through it with an online softmax,
so the (B, N, P) similarity never reaches device memory. At 256^2 the work
is arithmetic-bound (5.67 GFLOP against 11.8 MB); the source file says more.
Given ``kscale``, the keys are ``K * kscale`` per channel, applied in
float32 inside the kernel (as ``attention_pallas.py::_attn_shared_kernel``
derives its keys): the main path passes K = V and the background's inverse
norm, so no rounded K tensor is ever made.

``LAUNCHES`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from sketchedit_tpu_torch.ops.attention import (
    background_norm, extract_patches, fold_patches, keep_gate)

LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fwd = None


def _kernel():
    """The bound C entry point, built on first use."""
    global _fwd
    if _fwd is None:
        from sketchedit_tpu_torch.ops import _build
        lib = _build.load()["contextual_attention_fwd"]
        fn = lib.sketchedit_contextual_attention_fwd
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                       + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.sketchedit_cuda_error_string.argtypes = [ctypes.c_int]
        lib.sketchedit_cuda_error_string.restype = ctypes.c_char_p
        _fwd = (fn, lib.sketchedit_cuda_error_string)
    return _fwd


def attention_core_reference(Q, K, V, keep, softmax_scale: float = 10.0,
                             return_lse: bool = False, out_dtype=None,
                             kscale=None):
    """Plain version: bmm -> gate -> softmax -> bmm, in float32; the output
    comes back in ``out_dtype`` (default Q's dtype), the lse in float32."""
    Kf = K.float() if kscale is None else K.float() * kscale[:, None, :]
    logits = torch.bmm(Q.float(), Kf.transpose(1, 2))
    logits = logits * keep.float()[:, None, :] * softmax_scale
    out = torch.bmm(torch.softmax(logits, dim=-1), V.float()).to(
        out_dtype or Q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _check(Q, K, V, keep, out_dtype, kscale):
    if Q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention_core takes float32 or bfloat16, "
                        f"got {Q.dtype}")
    if K.dtype != Q.dtype or V.dtype != Q.dtype:
        raise TypeError("Q, K and V must share one dtype")
    if out_dtype not in (Q.dtype, torch.float32):
        raise TypeError(f"out_dtype must be {Q.dtype} or float32, "
                        f"got {out_dtype}")
    for name, t in (("keep", keep), ("kscale", kscale)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if Q.dim() != 3 or K.dim() != 3 or V.shape != K.shape:
        raise ValueError(f"want Q (B,N,D), K and V (B,P,D); got "
                         f"{tuple(Q.shape)}, {tuple(K.shape)}, "
                         f"{tuple(V.shape)}")
    B, _, D = Q.shape
    if (K.shape[0] != B or K.shape[2] != D or keep.shape != K.shape[:2]
            or (kscale is not None and kscale.shape != (B, D))):
        raise ValueError(f"shape mismatch: Q {tuple(Q.shape)}, K "
                         f"{tuple(K.shape)}, keep {tuple(keep.shape)}, "
                         f"kscale {None if kscale is None else tuple(kscale.shape)}")
    for name, t in (("Q", Q), ("K", K), ("V", V), ("keep", keep),
                    ("kscale", kscale)):
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != Q.device:
            raise ValueError(f"{name} is on {t.device}, Q on {Q.device}")


def attention_core(Q, K, V, keep, softmax_scale: float = 10.0,
                   return_lse: bool = False, out_dtype=None, kscale=None):
    """softmax((Q (K * kscale)^T) * keep * scale) V.

    Q (B,N,D), K and V (B,P,D), keep (B,P) float32 in {0, 1}, kscale (B,D)
    float32 or None (then the keys are K). Returns O (B,N,D) in
    ``out_dtype`` (Q's dtype by default, or float32), and the (B,N)
    float32 logsumexp when ``return_lse``.
    """
    global LAUNCHES
    out_dtype = out_dtype or Q.dtype
    _check(Q, K, V, keep, out_dtype, kscale)
    if Q.device.type == "cpu":
        return attention_core_reference(Q, K, V, keep, softmax_scale,
                                        return_lse, out_dtype, kscale)
    if Q.device.type != "cuda":
        raise ValueError(f"attention_core runs on cuda or cpu, not "
                         f"{Q.device}")
    fn, err_str = _kernel()
    B, N, D = Q.shape
    P = K.shape[1]
    out = torch.empty(Q.shape, dtype=out_dtype, device=Q.device)
    if kscale is None:
        kscale = torch.ones((B, D), dtype=torch.float32, device=Q.device)
    lse = (torch.empty((B, N), dtype=torch.float32, device=Q.device)
           if return_lse else None)
    stream = torch.cuda.current_stream(Q.device).cuda_stream
    rc = fn(_DTYPE_CODES[Q.dtype], _DTYPE_CODES[out_dtype], Q.data_ptr(),
            K.data_ptr(), V.data_ptr(), keep.data_ptr(), kscale.data_ptr(),
            out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, N, P, D, float(softmax_scale), stream)
    if rc != 0:
        raise RuntimeError(f"contextual_attention_fwd launch failed "
                           f"(B={B}, N={N}, P={P}, D={D}, {Q.dtype}): "
                           f"{err_str(rc).decode()}")
    LAUNCHES += 1
    return (out, lse) if return_lse else out


def attention_inputs(f, b, mask, *, patch_size: int = 4, stride: int = 2,
                     th: float = 0.1):
    """Q, V (contiguous, in f's dtype), keep and kscale (float32) for
    ``attention_core(Q, V, V, keep, kscale=kscale)`` from NCHW features and
    the feature-resolution hole mask. The keys are V * kscale, kscale the
    background's inverse L2 norm per channel: the norm is global per
    (batch, channel), so it factors out of the patch extraction. Q aliases
    V when ``f is b`` (the released call site)."""
    B, C = b.shape[:2]
    k, s = patch_size, stride
    kscale = (1.0 / background_norm(b)).reshape(B, C, 1).expand(
        B, C, k * k).reshape(B, C * k * k).contiguous()
    V = extract_patches(b, k, s).contiguous()
    Q = V if f is b else extract_patches(f, k, s).contiguous()
    return Q, V, keep_gate(mask, k, s, th), kscale


def contextual_attention_fused(f, b, mask, *, patch_size: int = 4,
                               stride: int = 2, softmax_scale: float = 10.0,
                               th: float = 0.1):
    """Drop-in for ``ops.attention.contextual_attention`` that runs the
    quadratic part through ``attention_core``. NCHW in and out. As in the
    dense version, the keys are formed in float32 and the kernel's float32
    output is folded in float32 and rounded once to the input dtype (the
    JAX package's Pallas path rounds K and the output to bfloat16)."""
    H, W = b.shape[2:]
    Q, V, keep, kscale = attention_inputs(f, b, mask, patch_size=patch_size,
                                          stride=stride, th=th)
    out = attention_core(Q, V, V, keep, softmax_scale,
                         out_dtype=torch.float32, kscale=kscale)
    return fold_patches(out, (H, W), patch_size, stride).to(f.dtype)
