"""Fused contextual attention on the GPU, forward and backward (counterpart
of ``sketchedit_tpu/ops/attention_pallas.py``).

``attention_core`` computes ``softmax((Q K^T) * keep * scale) V`` with the
splitcam gating quirk (a gated key gets logit 0). A CUDA tensor launches the
hand-written kernel ``csrc/contextual_attention_fwd.cu``, which replaces
``attention_pallas.py::_attn_kernel``, or the call raises; a CPU tensor takes
``attention_core_reference``, the plain PyTorch version. Nothing falls back
from one to the other. The flash-style backward comes in the same two
forms: ``attention_core_dq`` and ``attention_core_dkdv`` launch the kernels
of ``csrc/contextual_attention_bwd.cu`` (replacing ``_dq_kernel`` and
``_dkdv_kernel``) on CUDA tensors and take their plain versions on CPU
ones; ``attention_core_bwd`` runs both. ``ContextualAttentionCore`` ties
forward and backward together for autograd.

The kernel keeps the whole (TQ, D) float32 accumulator of a query tile in
shared memory and streams K and V tiles through it with an online softmax,
so the (B, N, P) similarity never reaches device memory. At 256^2 the work
is arithmetic-bound (5.67 GFLOP against 11.8 MB); the source file says more.
Given ``kscale``, the keys are ``K * kscale`` per channel, applied in
float32 inside the kernel (as ``attention_pallas.py::_attn_shared_kernel``
derives its keys): the main path passes K = V and the background's inverse
norm, so no rounded K tensor is ever made.

``LAUNCHES`` counts forward launches (``LAUNCHES_LSE`` those of them that
also wrote the logsumexp), ``LAUNCHES_DQ`` and ``LAUNCHES_DKDV`` the two
backward kernels', so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes

import torch

from sketchedit_tpu_torch.ops.attention import (
    background_norm, extract_patches, fold_patches, keep_gate)

LAUNCHES = 0
LAUNCHES_LSE = 0
LAUNCHES_DQ = 0
LAUNCHES_DKDV = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict = {}


def _kernel(name: str = "fwd"):
    """The bound C entry point ``name`` (fwd, dq or dkdv) and the library's
    error-string function, built on first use."""
    if not _fns:
        from sketchedit_tpu_torch.ops import _build
        libs = _build.load()
        fwd_lib = libs["contextual_attention_fwd"]
        bwd_lib = libs["contextual_attention_bwd"]
        fwd = fwd_lib.sketchedit_contextual_attention_fwd
        fwd.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        # dq: Q K V keep kscale dO lse delta dQ; dkdv: ... dK dV
        dq = bwd_lib.sketchedit_contextual_attention_dq
        dq.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
        dkdv = bwd_lib.sketchedit_contextual_attention_dkdv
        dkdv.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                         + [ctypes.c_int] * 4
                         + [ctypes.c_float, ctypes.c_void_p])
        for lib in (fwd_lib, bwd_lib):
            lib.sketchedit_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sketchedit_cuda_error_string.restype = ctypes.c_char_p
        for name_, fn, lib in (("fwd", fwd, fwd_lib), ("dq", dq, bwd_lib),
                               ("dkdv", dkdv, bwd_lib)):
            fn.restype = ctypes.c_int
            _fns[name_] = (fn, lib.sketchedit_cuda_error_string)
    return _fns[name]


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
    global LAUNCHES, LAUNCHES_LSE
    out_dtype = out_dtype or Q.dtype
    _check(Q, K, V, keep, out_dtype, kscale)
    if not _on_device(Q, "attention_core"):
        return attention_core_reference(Q, K, V, keep, softmax_scale,
                                        return_lse, out_dtype, kscale)
    fn, err_str = _kernel("fwd")
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
    LAUNCHES_LSE += return_lse
    return (out, lse) if return_lse else out


def _bwd_terms(Q, K, V, keep, lse, delta, dO, softmax_scale, kscale):
    """P, dS and the float32 Q and keys of the plain backward."""
    Qf = Q.float()
    Kf = K.float() if kscale is None else K.float() * kscale[:, None, :]
    gmul = (keep.float() * softmax_scale)[:, None, :]
    P = torch.exp(torch.bmm(Qf, Kf.transpose(1, 2)) * gmul - lse[..., None])
    dP = torch.bmm(dO, V.float().transpose(1, 2))
    return P, P * (dP - delta[..., None]) * gmul, Qf, Kf


def attention_core_dq_reference(Q, K, V, keep, lse, delta, dO,
                                softmax_scale: float = 10.0, kscale=None):
    """Plain version of the dQ kernel, in float32: with K_eff = K * kscale,
    g = keep * scale, P = exp((Q K_eff^T) g - lse), dP = dO V^T and
    dS = P (dP - delta) g, dQ = dS K_eff."""
    _, dS, _, Kf = _bwd_terms(Q, K, V, keep, lse, delta, dO, softmax_scale,
                              kscale)
    return torch.bmm(dS, Kf)


def attention_core_dkdv_reference(Q, K, V, keep, lse, delta, dO,
                                  softmax_scale: float = 10.0, kscale=None):
    """Plain version of the dK/dV kernel, in float32: (dK_eff = dS^T Q,
    dV = P^T dO), the terms as in ``attention_core_dq_reference``."""
    P, dS, Qf, _ = _bwd_terms(Q, K, V, keep, lse, delta, dO, softmax_scale,
                              kscale)
    return torch.bmm(dS.transpose(1, 2), Qf), torch.bmm(P.transpose(1, 2), dO)


def attention_core_bwd_reference(Q, K, V, keep, out, lse, dO,
                                 softmax_scale: float = 10.0, kscale=None):
    """Plain version of the backward: delta = rowsum(dO O), then the two
    kernels' plain versions. Returns (dQ, dK_eff, dV), float32."""
    delta = (dO * out).sum(-1)
    args = (Q, K, V, keep, lse, delta, dO, softmax_scale, kscale)
    return (attention_core_dq_reference(*args),
            *attention_core_dkdv_reference(*args))


def _check_bwd(Q, K, V, keep, lse, delta, dO, kscale):
    _check(Q, K, V, keep, Q.dtype, kscale)
    B, N, D = Q.shape
    for name, t, shape in (("lse", lse, (B, N)), ("delta", delta, (B, N)),
                           ("dO", dO, (B, N, D))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != Q.device:
            raise ValueError(f"{name} must be contiguous on {Q.device}")


def _launch_bwd(name, Q, K, V, keep, lse, delta, dO, softmax_scale, kscale,
                outs):
    B, N, D = Q.shape
    P = K.shape[1]
    if kscale is None:
        kscale = torch.ones((B, D), dtype=torch.float32, device=Q.device)
    fn, err_str = _kernel(name)
    rc = fn(_DTYPE_CODES[Q.dtype], Q.data_ptr(), K.data_ptr(), V.data_ptr(),
            keep.data_ptr(), kscale.data_ptr(), dO.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), *(t.data_ptr() for t in outs), B, N, P, D,
            float(softmax_scale), torch.cuda.current_stream(Q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"contextual_attention_{name} launch failed "
                           f"(B={B}, N={N}, P={P}, D={D}, {Q.dtype}): "
                           f"{err_str(rc).decode()}")


def _on_device(Q, what):
    if Q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what} runs on cuda or cpu, not {Q.device}")
    return Q.device.type == "cuda"


def attention_core_dq(Q, K, V, keep, lse, delta, dO,
                      softmax_scale: float = 10.0, kscale=None):
    """dQ (float32) of ``attention_core``, given the forward's logsumexp,
    delta = rowsum(dO O) and the float32 output gradient dO. A CUDA tensor
    launches the dQ kernel; a CPU tensor takes the plain version."""
    global LAUNCHES_DQ
    _check_bwd(Q, K, V, keep, lse, delta, dO, kscale)
    if not _on_device(Q, "attention_core_dq"):
        return attention_core_dq_reference(Q, K, V, keep, lse, delta, dO,
                                           softmax_scale, kscale)
    dQ = torch.empty(Q.shape, dtype=torch.float32, device=Q.device)
    _launch_bwd("dq", Q, K, V, keep, lse, delta, dO, softmax_scale, kscale,
                (dQ,))
    LAUNCHES_DQ += 1
    return dQ


def attention_core_dkdv(Q, K, V, keep, lse, delta, dO,
                        softmax_scale: float = 10.0, kscale=None):
    """(dK_eff, dV), float32, of ``attention_core``: dK_eff is the gradient
    of the keys K * kscale. A CUDA tensor launches the fused dK/dV kernel;
    a CPU tensor takes the plain version."""
    global LAUNCHES_DKDV
    _check_bwd(Q, K, V, keep, lse, delta, dO, kscale)
    if not _on_device(Q, "attention_core_dkdv"):
        return attention_core_dkdv_reference(Q, K, V, keep, lse, delta, dO,
                                             softmax_scale, kscale)
    dK, dV = (torch.empty(K.shape, dtype=torch.float32, device=K.device)
              for _ in range(2))
    _launch_bwd("dkdv", Q, K, V, keep, lse, delta, dO, softmax_scale, kscale,
                (dK, dV))
    LAUNCHES_DKDV += 1
    return dK, dV


def attention_core_bwd(Q, K, V, keep, out, lse, dO,
                       softmax_scale: float = 10.0, kscale=None):
    """Gradients of ``attention_core`` given its float32 output ``out``, its
    logsumexp ``lse`` and the float32 output gradient ``dO``: (dQ, dK_eff,
    dV), float32. delta = rowsum(dO O) is a plain reduction, as in the JAX
    package; then the dQ kernel and the fused dK/dV kernel (on the CPU,
    their plain versions)."""
    if out.dtype != torch.float32 or out.shape != dO.shape:
        raise ValueError(f"out must be float32 {tuple(dO.shape)}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    delta = (dO * out).sum(-1)
    args = (Q, K, V, keep, lse, delta, dO, softmax_scale, kscale)
    return (attention_core_dq(*args), *attention_core_dkdv(*args))


class ContextualAttentionCore(torch.autograd.Function):
    """``attention_core`` with a float32 output, differentiable in Q, K, V
    and kscale (the JAX package's ``custom_vjp``). The forward keeps the
    float32 output and the logsumexp; the backward runs
    ``attention_core_bwd`` and folds dK_eff back onto K and kscale in
    float32: dK = dK_eff * kscale, dkscale = sum_P dK_eff * K. keep gets no
    gradient (a threshold). When Q, K and V are one tensor (the main path),
    the three gradients are summed in float32 and returned once."""

    @staticmethod
    def forward(ctx, Q, K, V, keep, kscale, softmax_scale):
        out, lse = attention_core(Q, K, V, keep, softmax_scale,
                                  return_lse=True, out_dtype=torch.float32,
                                  kscale=kscale)
        ctx.softmax_scale = softmax_scale
        ctx.shared = Q is K and K is V
        ctx.save_for_backward(Q, K, V, keep, kscale, out, lse)
        return out

    @staticmethod
    def backward(ctx, dO):
        Q, K, V, keep, kscale, out, lse = ctx.saved_tensors
        dQ, dK_eff, dV = attention_core_bwd(
            Q, K, V, keep, out, lse, dO.float().contiguous(),
            ctx.softmax_scale, kscale)
        dK = dK_eff * kscale[:, None, :]
        dkscale = ((dK_eff * K.float()).sum(1) if ctx.needs_input_grad[4]
                   else None)
        if ctx.shared:
            return (dQ + dK + dV).to(V.dtype), None, None, None, dkscale, None
        return (dQ.to(Q.dtype), dK.to(K.dtype), dV.to(V.dtype), None,
                dkscale, None)


def attention_core_differentiable(Q, K, V, keep, softmax_scale: float = 10.0,
                                  kscale=None):
    """``attention_core`` with a float32 output through
    ``ContextualAttentionCore`` when autograd needs it; otherwise the plain
    call, which skips the logsumexp and saves nothing."""
    if kscale is None:
        kscale = torch.ones((Q.shape[0], Q.shape[2]), dtype=torch.float32,
                            device=Q.device)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (Q, K, V, kscale)):
        return ContextualAttentionCore.apply(Q, K, V, keep, kscale,
                                             softmax_scale)
    return attention_core(Q, K, V, keep, softmax_scale,
                          out_dtype=torch.float32, kscale=kscale)


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
    quadratic part through ``attention_core``, differentiable through the
    backward kernels. NCHW in and out. As in the dense version, the keys
    are formed in float32 and the kernel's float32 output is folded in
    float32 and rounded once to the input dtype (the JAX package's Pallas
    path rounds K and the output to bfloat16)."""
    H, W = b.shape[2:]
    Q, V, keep, kscale = attention_inputs(f, b, mask, patch_size=patch_size,
                                          stride=stride, th=th)
    out = attention_core_differentiable(Q, V, V, keep, softmax_scale,
                                        kscale=kscale)
    return fold_patches(out, (H, W), patch_size, stride).to(f.dtype)
