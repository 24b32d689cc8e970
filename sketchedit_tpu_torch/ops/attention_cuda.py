"""Fused contextual attention on the GPU, forward and backward (counterpart
of ``sketchedit_tpu/ops/attention_pallas.py``).

``attention_core`` computes ``softmax((Q K^T) * keep * scale) V`` with the
splitcam gating quirk (a gated key gets logit 0). A CUDA tensor launches the
hand-written kernel ``csrc/contextual_attention_fwd.cu``, which replaces
``attention_pallas.py::_attn_kernel``, or the call raises; a CPU tensor takes
``attention_core_reference``, the plain PyTorch version. Nothing falls back
from one to the other. The same file holds two more forwards of the same
function: ``attention_core_shared`` (``_attn_shared_kernel``: queries, keys
and values are one tensor, one pointer) and ``attention_core_dsplit``
(``_attn_kernel_dsplit``: a 16-row query tile is a cluster of two blocks,
each owning one half of D, which share their partial S tiles through
distributed shared memory, both products in split TF32 on the tensor
cores; inference only; ``dsplit_plan`` says how it runs a shape). The
flash-style backward comes in the same two forms:
``attention_core_dq`` and ``attention_core_dkdv`` launch the kernels of
``csrc/contextual_attention_bwd.cu`` (replacing ``_dq_kernel`` and
``_dkdv_kernel``; both are the default forward's sequence of launches on
warpgroup ``wgmma`` fed by TMA: the operands' TF32 terms in a scratch,
then for dQ per chunk of query rows S, dP, a weights pass forming dS and
dQ = dS K as products, ``dq_scratch`` and ``dq_plan`` say how it runs a
shape; for the fused dK/dV per chunk of key rows S, dP, a weights pass
forming P^T and dS^T, dV = P^T dO and dK = dS^T Q as products,
``dkdv_scratch`` and ``dkdv_plan`` say how it runs a shape) on CUDA
tensors and take their plain versions on CPU ones. ``attention_core_bwd_joint``
gives dQ, dK and dV from one sequence: the fused dK/dV's, whose weights
pass also writes dS by rows, with dQ = dS K added to each chunk of keys,
so S, dP and dS are formed once for the three products (``bwd_scratch``
and ``bwd_plan`` say how it runs a shape). That sequence runs with a mask
of its products (the C entry point ``grad``): the joint takes all three,
the fused dK/dV dV and dK, and the single-output ``attention_core_dv`` and
``attention_core_dk`` (replacing ``_dv_kernel`` and ``_dk_kernel``) one
each, every masked sequence launching only the copies, products and
weights its products read (``dk_dv_plan``). ``attention_core_bwd`` takes
the joint sequence, or dQ and then dV and dK.
``ContextualAttentionCore`` ties forward and backward together for
autograd.

Three environment variables, read on every call (as the JAX package reads
them), choose among the kernels: ``SKETCHEDIT_SHARED_ATTN=1`` (the shared forward,
where foreground and background are one tensor) and
``SKETCHEDIT_DSPLIT_ATTN=1`` (the D-split forward) in
``contextual_attention_fused``; ``SKETCHEDIT_SPLIT_DKDV=1`` in
``attention_core_bwd`` (dQ's sequence, then dV and dK alone).

The three forwards run both products on the tensor cores in split TF32
(float32-accurate: three passes for float32 operands, two where one
operand holds bfloat16 data). The default and shared forwards are one
sequence of launches on warpgroup ``wgmma`` fed by TMA: the operands'
TF32 terms (K, V transposed, Q * kscale) are formed in a scratch the
wrapper allocates, S = (Q kscale) K^T is one product, a softmax pass forms
P, and P V is a second product; the scratch's query-row part is capped at
``SCRATCH_CAP`` bytes, past which the query rows go in chunks
(``fwd_scratch``, ``fwd_plan`` say how a shape runs). The D-split keeps a
query tile's float32 accumulator in its two blocks' registers, with K and
V streaming through an online softmax (``dsplit_plan``). At 256^2 the work
is arithmetic (5.67 GFLOP against 11.8 MB); the source file says more.
Given ``kscale``, the keys are ``K * kscale`` per channel, applied in
float32 inside the kernel (as ``attention_pallas.py::_attn_shared_kernel``
derives its keys): the main path passes K = V and the background's inverse
norm, so no rounded K tensor is ever made. The JAX package's shared
backward materialises K = V * kscale in the input type, bfloat16 included;
here the keys stay float32 in every kernel, a documented difference of
rounding.

Every kernel is a ``torch.library`` custom op of the ``sketchedit``
namespace (``attention_fwd``, ``attention_fwd_shared``,
``attention_fwd_dsplit``, ``attention_dq``, ``attention_dkdv``,
``attention_bwd``, ``attention_dv``, ``attention_dk``): its CUDA
implementation launches the kernel, its CPU implementation is the plain
version, and its fake implementation gives the output shapes, so
``torch.export`` traces a call into the graph (``server/artifact.py``). The dispatcher picks the
implementation by the tensors' device; any device other than ``cuda`` or
``cpu`` raises. The public functions below check their inputs and call the
ops. A forward op always returns (out, lse), the lse an empty tensor when it
was not asked for, since a custom op cannot return None.

``LAUNCHES``, ``LAUNCHES_SHARED`` and ``LAUNCHES_DSPLIT`` count the three
forward kernels' launches (``LAUNCHES_LSE`` those of any of them that also
wrote the logsumexp), ``LAUNCHES_DQ``, ``LAUNCHES_DKDV``, ``LAUNCHES_BWD``
(the joint sequence), ``LAUNCHES_DV`` and ``LAUNCHES_DK`` the backward
kernels', so a run can show that its main path went through them; they
may be read and set from outside, and the wrappers add to them under a
lock, since pipeline replicas launch from several threads. Every launch runs with its tensors' device current,
whichever device the caller has current.
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import Optional

import torch
from torch import Tensor

from sketchedit_tpu_torch.ops.attention import (
    background_norm, extract_patches, fold_patches, keep_gate)

LAUNCHES = 0
LAUNCHES_SHARED = 0
LAUNCHES_DSPLIT = 0
LAUNCHES_LSE = 0
LAUNCHES_DQ = 0
LAUNCHES_DKDV = 0
LAUNCHES_BWD = 0
LAUNCHES_DV = 0
LAUNCHES_DK = 0
_COUNT_LOCK = threading.Lock()
# The default and shared forwards' scratch may spend up to this many bytes
# on the part that grows with the query rows (their split terms, the
# logits, P's terms), dQ's on the same part (S, dP, dS's terms), the fused
# dK/dV's on the part that grows with the key rows (S, dP, the weights'
# terms; the joint backward's also dS's terms by rows); a larger call takes
# them in chunks.
SCRATCH_CAP = 256 << 20

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_fns: dict = {}
# C entry point -> (library, leading dtype ints, pointers, dimension ints);
# every signature ends with the float scale and the stream
_ENTRY_POINTS = {
    "fwd": ("contextual_attention_fwd", 2, 8, 5),
    "fwd_dsplit": ("contextual_attention_fwd", 2, 7, 4),
    "fwd_shared": ("contextual_attention_fwd", 2, 6, 4),
    "dq": ("contextual_attention_bwd", 1, 10, 5),
    "grad": ("contextual_attention_bwd", 2, 12, 5),
}
# the products of the backward sequence that ``grad`` launches (its C
# mask), and the mask each backward op runs: the joint backward all three
GRAD_DV, GRAD_DK, GRAD_DQ = 1, 2, 4
_GRAD_MASKS = {"dkdv": GRAD_DV | GRAD_DK, "bwd": GRAD_DV | GRAD_DK | GRAD_DQ,
               "dv": GRAD_DV, "dk": GRAD_DK}


def _count(counter: str, n: int = 1):
    """Add ``n`` to the module's launch counter named ``counter``."""
    with _COUNT_LOCK:
        globals()[counter] += n


def _kernel(name: str = "fwd"):
    """The bound C entry point ``name`` (a key of ``_ENTRY_POINTS``) and its
    library's error-string function, built on first use."""
    if not _fns:
        from sketchedit_tpu_torch.ops import _build
        libs = _build.load()
        for name_, (stem, n_dtypes, n_ptrs, n_dims) in _ENTRY_POINTS.items():
            lib = libs[stem]
            lib.sketchedit_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sketchedit_cuda_error_string.restype = ctypes.c_char_p
            fn = getattr(lib, f"sketchedit_contextual_attention_{name_}")
            fn.argtypes = ([ctypes.c_int] * n_dtypes
                           + [ctypes.c_void_p] * n_ptrs
                           + [ctypes.c_int] * n_dims
                           + [ctypes.c_float, ctypes.c_void_p])
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
    if Q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"the attention kernels run on cuda or cpu, not "
                         f"{Q.device}")


def _forward_on_device(name, Q, K, V, keep, softmax_scale, return_lse,
                       out_dtype, kscale):
    """Launch the forward kernel ``name`` (fwd, fwd_dsplit or fwd_shared; the
    last takes V alone) on checked CUDA tensors; returns (out, lse or None)."""
    fn, err_str = _kernel(name)
    B, N, D = Q.shape
    P = K.shape[1]
    out = torch.empty(Q.shape, dtype=out_dtype, device=Q.device)
    kscale = _kscale_or_ones(Q, kscale)
    lse = (torch.empty((B, N), dtype=torch.float32, device=Q.device)
           if return_lse else None)
    tensors = (V,) if name == "fwd_shared" else (Q, K, V)
    dims = (B, N, D) if name == "fwd_shared" else (B, N, P, D)
    scratch = ()
    if name != "fwd_dsplit":       # the wgmma forwards' scratch and chunks
        nbytes, rows = fwd_scratch(B, N, P, D, Q.dtype)
        buf = torch.empty(nbytes, dtype=torch.uint8, device=Q.device)
        scratch, dims = (buf.data_ptr(),), (*dims, rows)
    with torch.cuda.device(Q.device):  # a launch runs on the current device
        rc = fn(_DTYPE_CODES[Q.dtype], _DTYPE_CODES[out_dtype],
                *(t.data_ptr() for t in tensors), keep.data_ptr(),
                kscale.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), *scratch, *dims,
                float(softmax_scale),
                torch.cuda.current_stream(Q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"contextual_attention_{name} launch failed "
                           f"(B={B}, N={N}, P={P}, D={D}, {Q.dtype}): "
                           f"{err_str(rc).decode()}")
    _count("LAUNCHES_LSE", int(return_lse))
    return out, lse


def attention_core(Q, K, V, keep, softmax_scale: float = 10.0,
                   return_lse: bool = False, out_dtype=None, kscale=None):
    """softmax((Q (K * kscale)^T) * keep * scale) V.

    Q (B,N,D), K and V (B,P,D), keep (B,P) float32 in {0, 1}, kscale (B,D)
    float32 or None (then the keys are K). Returns O (B,N,D) in
    ``out_dtype`` (Q's dtype by default, or float32), and the (B,N)
    float32 logsumexp when ``return_lse``.
    """
    out_dtype = out_dtype or Q.dtype
    _check(Q, K, V, keep, out_dtype, kscale)
    out, lse = _fwd_op(Q, K, V, keep, kscale, float(softmax_scale),
                       out_dtype, return_lse)
    return (out, lse) if return_lse else out


def attention_core_shared_reference(V, kscale, keep,
                                    softmax_scale: float = 10.0,
                                    return_lse: bool = False, out_dtype=None):
    """Plain version of the shared-tensor forward: queries and values are
    V, the keys V * kscale, in float32."""
    return attention_core_reference(V, V, V, keep, softmax_scale, return_lse,
                                    out_dtype, kscale)


def attention_core_shared(V, kscale, keep, softmax_scale: float = 10.0,
                          return_lse: bool = False, out_dtype=None):
    """``attention_core(V, V, V, keep, kscale=kscale)`` from one tensor: V
    (B,N,D) is queries and values, the keys are V * kscale (kscale (B,D)
    float32), keep (B,N). A CUDA tensor launches the shared-tensor kernel,
    which takes the one pointer; a CPU tensor takes the plain version."""
    out_dtype = out_dtype or V.dtype
    _check(V, V, V, keep, out_dtype, kscale)
    if kscale is None:
        raise ValueError("attention_core_shared needs kscale")
    out, lse = _fwd_shared_op(V, kscale, keep, float(softmax_scale),
                              out_dtype, return_lse)
    return (out, lse) if return_lse else out


def dsplit_cut(D: int) -> int:
    """Width of the D-split's first half: ceil(D / 2), rounded up to 4."""
    return ((D + 1) // 2 + 3) // 4 * 4


def attention_core_dsplit_reference(Q, K, V, keep, softmax_scale: float = 10.0,
                                    return_lse: bool = False, out_dtype=None,
                                    kscale=None):
    """Plain version of the D-split forward: each half of the output's
    columns from its own pass (S over the full D recomputed, that half of V
    alone), the halves concatenated; the lse is the first half's."""
    cut = dsplit_cut(Q.shape[2])
    halves, lse = [], None
    for lo, hi in ((0, cut), (cut, Q.shape[2])):
        if lo >= hi:
            continue
        Kf = K.float() if kscale is None else K.float() * kscale[:, None, :]
        logits = torch.bmm(Q.float(), Kf.transpose(1, 2))
        logits = logits * keep.float()[:, None, :] * softmax_scale
        halves.append(torch.bmm(torch.softmax(logits, dim=-1),
                                V[..., lo:hi].float()))
        if lse is None:
            lse = torch.logsumexp(logits, dim=-1)
    out = torch.cat(halves, dim=-1).to(out_dtype or Q.dtype)
    return (out, lse) if return_lse else out


def attention_core_dsplit(Q, K, V, keep, softmax_scale: float = 10.0,
                          return_lse: bool = False, out_dtype=None,
                          kscale=None):
    """``attention_core`` through the D-split kernel (a 16-row query tile
    is a cluster of two blocks, each owning one half of D: each contracts
    its half for a partial S, the two sum their partials through
    distributed shared memory, and each accumulates its half of the output,
    both products in split TF32 on the tensor cores; D up to 3584; needs
    sm_90). No backward: it raises where autograd would need one. A CUDA
    tensor launches the kernel; a CPU tensor takes the plain version."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (Q, K, V, kscale)):
        raise RuntimeError(
            "the D-split attention kernel (SKETCHEDIT_DSPLIT_ATTN=1) is "
            "inference only: it has no backward. Unset the variable to "
            "train, or call it under torch.no_grad()")
    out_dtype = out_dtype or Q.dtype
    _check(Q, K, V, keep, out_dtype, kscale)
    out, lse = _fwd_dsplit_op(Q, K, V, keep, kscale, float(softmax_scale),
                              out_dtype, return_lse)
    return (out, lse) if return_lse else out


_PLAN_KEYS = ("tile_rows", "cluster_blocks", "max_active_clusters",
              "smem_bytes", "grid_clusters")


def _plan(name: str, codes: tuple, B: int, N: int, P: int, D: int,
          keys: tuple = _PLAN_KEYS) -> dict:
    """The launch plan of kernel ``name`` (fwd, fwd_dsplit, dq or grad) on
    the current CUDA device, from its C ``..._plan`` entry point:
    ``codes`` are its leading int arguments, ``keys`` name the five ints it
    fills."""
    from sketchedit_tpu_torch.ops import _build
    _, err_str = _kernel(name)
    lib = _build.load()[_ENTRY_POINTS[name][0]]
    fn = getattr(lib, f"sketchedit_contextual_attention_{name}_plan")
    fn.argtypes = [ctypes.c_int] * (len(codes) + 4) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    plan = (ctypes.c_int * len(keys))()
    rc = fn(*codes, B, N, P, D, ctypes.addressof(plan))
    if rc != 0:
        raise RuntimeError(f"contextual_attention_{name}_plan failed "
                           f"(B={B}, N={N}, P={P}, D={D}): "
                           f"{err_str(rc).decode()}")
    return dict(zip(keys, plan))


def dsplit_plan(B: int, N: int, P: int, D: int, dtype=torch.float32,
                out_dtype=torch.float32) -> dict:
    """How the D-split kernel runs these shapes on the current CUDA device,
    without launching it: the query tile's rows, the blocks of a cluster,
    the most clusters resident at once (``cudaOccupancyMaxActiveClusters``),
    each block's dynamic shared memory in bytes, and the clusters of the
    grid."""
    return _plan("fwd_dsplit", (_DTYPE_CODES[dtype], _DTYPE_CODES[out_dtype]),
                 B, N, P, D)


def fwd_scratch(B: int, N: int, P: int, D: int, dtype=torch.float32,
                cap: Optional[int] = None) -> tuple[int, int]:
    """(bytes, rows): the scratch the default and shared forwards take for
    these shapes, and the query rows of each chunk, when the part that
    grows with the query rows may take ``cap`` bytes (``SCRATCH_CAP`` by
    default)."""
    return _scratch("fwd", _DTYPE_CODES[dtype], B, N, P, D,
                    cap=SCRATCH_CAP if cap is None else cap)


@functools.lru_cache(maxsize=256)
def _scratch(name: str, *ints: int, cap: int) -> tuple[int, int]:
    """(bytes, rows) from the C entry point ``..._<name>_scratch``, which
    takes ``ints``, the cap and a pointer that gets the chunk's rows."""
    from sketchedit_tpu_torch.ops import _build
    lib = _build.load()[_ENTRY_POINTS[name][0]]
    fn = getattr(lib, f"sketchedit_contextual_attention_{name}_scratch")
    fn.argtypes = ([ctypes.c_int] * len(ints)
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_longlong
    rows = ctypes.c_int(0)
    nbytes = fn(*ints, cap, ctypes.addressof(rows))
    if nbytes < 0:
        raise ValueError(f"no {name} scratch for {ints}")
    return int(nbytes), rows.value


# the phases of the default and shared forwards, in launch order; the last
# four repeat for each chunk of query rows
FWD_PHASES = ("keys", "values", "queries", "logits", "softmax", "pv")
_WGMMA_PLAN_KEYS = ("chunk_rows", "chunks", "logits_blocks",
                    "softmax_blocks", "pv_blocks", "logits_smem_bytes",
                    "pv_smem_bytes", "logits_stages", "pv_stages",
                    "logits_blocks_per_sm", "pv_blocks_per_sm",
                    "threads_per_block", "launches_per_call",
                    "logits_block_rows", "logits_block_cols",
                    "pv_block_rows", "pv_block_cols")


def fwd_plan(B: int, N: int, P: int, D: int, dtype=torch.float32,
             out_dtype=torch.float32, shared: bool = False,
             cap: Optional[int] = None) -> dict:
    """How the default forward (or, with ``shared``, the shared-tensor one;
    both run the same kernels) runs these shapes on the current CUDA
    device, without launching it: the query rows of a chunk and the
    chunks, the blocks of the logits (S), softmax and P V launches of a
    full chunk, the two wgmma products' dynamic shared memory per block,
    their pipeline stages and resident blocks per SM, the threads of a
    product block, the CUDA launches per call, each product's block rows
    and columns, ``phases`` in launch order and the scratch in bytes
    (``fwd_scratch``)."""
    nbytes, rows = fwd_scratch(B, N, P, D, dtype, cap)
    plan = _plan("fwd", (int(shared), _DTYPE_CODES[dtype],
                         _DTYPE_CODES[out_dtype], rows), B, N, P, D,
                 _WGMMA_PLAN_KEYS)
    return {**plan, "phases": list(FWD_PHASES), "scratch_bytes": nbytes}


def dq_scratch(B: int, N: int, P: int, D: int, dtype=torch.float32,
               same: bool = True, cap: Optional[int] = None
               ) -> tuple[int, int]:
    """(bytes, rows): the scratch dQ takes for these shapes (``same``: V is
    K, one tensor, whose terms serve S and dP), and the query rows of each
    chunk, when the part that grows with the query rows may take ``cap``
    bytes (``SCRATCH_CAP`` by default)."""
    return _scratch("dq", _DTYPE_CODES[dtype], int(same), B, N, P, D,
                    cap=SCRATCH_CAP if cap is None else cap)


# the phases of dQ, in launch order: the split copies (K by rows, K
# transposed, Q kscale and dO by rows), then per chunk of query rows the S
# and dP products, the weights pass and the dQ product
DQ_PHASES = ("keys", "keys_t", "queries", "grads", "logits", "dp", "weights",
             "dq")
_DQ_PLAN_KEYS = ("chunk_rows", "chunks", "logits_blocks", "weights_blocks",
                 "dq_blocks", "logits_smem_bytes", "dq_smem_bytes",
                 "logits_stages", "dq_stages", "logits_blocks_per_sm",
                 "dq_blocks_per_sm", "threads_per_block", "launches_per_call",
                 "logits_block_rows", "logits_block_cols", "dq_block_rows",
                 "dq_block_cols", "producer_registers", "consumer_registers")


def dq_plan(B: int, N: int, P: int, D: int, dtype=torch.float32,
            cap: Optional[int] = None) -> dict:
    """How dQ runs these shapes on the current CUDA device (V taken to be
    K, as on the main path), without launching it: the query rows of a
    chunk and the chunks, the blocks of the S (``logits``; dP's are the
    same), weights and dQ launches of a full chunk, the two product kinds'
    dynamic shared memory per block, their pipeline stages and resident
    blocks per SM, the threads of a product block, the CUDA launches per
    call, each product's block rows and columns, the registers a thread
    that a product block's producer warpgroup and its consumers set,
    ``phases`` in launch order and the scratch in bytes (``dq_scratch``)."""
    nbytes, rows = dq_scratch(B, N, P, D, dtype, True, cap)
    plan = _plan("dq", (_DTYPE_CODES[dtype], rows), B, N, P, D,
                 _DQ_PLAN_KEYS)
    return {**plan, "phases": list(DQ_PHASES), "scratch_bytes": nbytes}


def _grad_scratch(mask: int, B: int, N: int, P: int, D: int, dtype,
                  same: bool, cap: Optional[int]) -> tuple[int, int]:
    """(bytes, rows) of the backward sequence run with ``mask``."""
    return _scratch("grad", _DTYPE_CODES[dtype], mask, int(same), B, N, P, D,
                    cap=SCRATCH_CAP if cap is None else cap)


def dkdv_scratch(B: int, N: int, P: int, D: int, dtype=torch.float32,
                 same: bool = True, cap: Optional[int] = None
                 ) -> tuple[int, int]:
    """(bytes, rows): the scratch the fused dK/dV takes for these shapes
    (``same``: V is K, one tensor, whose terms serve S and dP), and the key
    rows of each chunk, when the part that grows with the key rows may take
    ``cap`` bytes (``SCRATCH_CAP`` by default)."""
    return _grad_scratch(_GRAD_MASKS["dkdv"], B, N, P, D, dtype, same, cap)


def bwd_scratch(B: int, N: int, P: int, D: int, dtype=torch.float32,
                same: bool = True, cap: Optional[int] = None
                ) -> tuple[int, int]:
    """(bytes, rows): the scratch the joint backward takes for these shapes
    (the fused dK/dV's, with K transposed and dS's terms by rows), and the
    key rows of each chunk, when the part that grows with the key rows may
    take ``cap`` bytes (``SCRATCH_CAP`` by default)."""
    return _grad_scratch(_GRAD_MASKS["bwd"], B, N, P, D, dtype, same, cap)


def grad_phases(mask: int) -> tuple:
    """The phases of the backward sequence run with ``mask``, in launch
    order: the split copies (by rows: K, Q kscale, and dO where dP is
    formed; transposed: Q for dK, dO for dV, K for dQ), then per chunk of
    key rows the S product, the dP product (for dK or dQ), the weights pass
    and the mask's products (dV, dK, dQ)."""
    dp = bool(mask & (GRAD_DK | GRAD_DQ))
    pick = lambda *named: tuple(n for n, on in named if on)
    return (pick(("keys", True), ("queries", True), ("grads", dp),
                 ("queries_t", mask & GRAD_DK), ("grads_t", mask & GRAD_DV),
                 ("keys_t", mask & GRAD_DQ))
            + pick(("logits", True), ("dp", dp), ("weights", True),
                   ("dv", mask & GRAD_DV), ("dk", mask & GRAD_DK),
                   ("dq", mask & GRAD_DQ)))


DKDV_PHASES = grad_phases(_GRAD_MASKS["dkdv"])
BWD_PHASES = grad_phases(_GRAD_MASKS["bwd"])
# the 31 ints of the C grad_plan: every product described, whatever the mask
_BWD_PLAN_KEYS = ("chunk_rows", "chunks", "logits_blocks", "weights_blocks",
                  "dv_blocks", "dk_blocks", "logits_smem_bytes",
                  "dv_smem_bytes", "dk_smem_bytes", "logits_stages",
                  "dv_stages", "dk_stages", "logits_blocks_per_sm",
                  "dv_blocks_per_sm", "dk_blocks_per_sm",
                  "threads_per_block", "launches_per_call",
                  "logits_block_rows", "logits_block_cols",
                  "dv_block_rows", "dv_block_cols", "dk_block_rows",
                  "dk_block_cols", "dq_blocks", "dq_smem_bytes",
                  "dq_stages", "dq_blocks_per_sm", "dq_block_rows",
                  "dq_block_cols", "producer_registers",
                  "consumer_registers")


def _grad_plan(mask: int, B: int, N: int, P: int, D: int, dtype,
               cap: Optional[int]) -> dict:
    """How the backward sequence run with ``mask`` runs these shapes on the
    current CUDA device (V taken to be K, as on the main path), without
    launching it: the key rows of a chunk and the chunks, the blocks of the
    S (``logits``; dP's are the same), weights and product launches of a
    full chunk, each of the mask's product kinds' dynamic shared memory per
    block, pipeline stages, resident blocks per SM and block rows and
    columns, the threads of a product block, the CUDA launches per call,
    the registers a thread that a product block's producer warpgroup and
    its consumers set, ``phases`` in launch order and the scratch in
    bytes."""
    nbytes, rows = _grad_scratch(mask, B, N, P, D, dtype, True, cap)
    plan = _plan("grad", (_DTYPE_CODES[dtype], mask, rows), B, N, P, D,
                 _BWD_PLAN_KEYS)
    left_out = {k for k, bit in (("dv", GRAD_DV), ("dk", GRAD_DK),
                                 ("dq", GRAD_DQ)) if not mask & bit}
    return {**{k: v for k, v in plan.items()
               if k.split("_")[0] not in left_out},
            "phases": list(grad_phases(mask)), "scratch_bytes": nbytes}


def dkdv_plan(B: int, N: int, P: int, D: int, dtype=torch.float32,
              cap: Optional[int] = None) -> dict:
    """How the fused dK/dV runs these shapes (``_grad_plan``'s keys for dV
    and dK; scratch as ``dkdv_scratch``)."""
    return _grad_plan(_GRAD_MASKS["dkdv"], B, N, P, D, dtype, cap)


def bwd_plan(B: int, N: int, P: int, D: int, dtype=torch.float32,
             cap: Optional[int] = None) -> dict:
    """How the joint backward runs these shapes (``_grad_plan``'s keys for
    dV, dK and dQ; scratch as ``bwd_scratch``)."""
    return _grad_plan(_GRAD_MASKS["bwd"], B, N, P, D, dtype, cap)


def dk_dv_plan(B: int, N: int, P: int, D: int, dtype=torch.float32,
               dk: bool = True, cap: Optional[int] = None) -> dict:
    """How dK alone (or, without ``dk``, dV alone) runs these shapes: the
    backward sequence with a mask of that one product (``_grad_plan``'s
    keys for it, as ``dkdv_plan`` gives them)."""
    return _grad_plan(_GRAD_MASKS["dk" if dk else "dv"], B, N, P, D, dtype,
                      cap)


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


def attention_core_dv_reference(Q, K, keep, lse, dO,
                                softmax_scale: float = 10.0, kscale=None):
    """Plain version of the dV kernel, in float32: dV = P^T dO with
    P = exp((Q K_eff^T) g - lse); reads neither V nor delta."""
    Kf = K.float() if kscale is None else K.float() * kscale[:, None, :]
    gmul = (keep.float() * softmax_scale)[:, None, :]
    P = torch.exp(torch.bmm(Q.float(), Kf.transpose(1, 2)) * gmul
                  - lse[..., None])
    return torch.bmm(P.transpose(1, 2), dO)


def attention_core_dk_reference(Q, K, V, keep, lse, delta, dO,
                                softmax_scale: float = 10.0, kscale=None):
    """Plain version of the dK kernel, in float32: dK_eff = dS^T Q, the
    terms as in ``attention_core_dq_reference``."""
    _, dS, Qf, _ = _bwd_terms(Q, K, V, keep, lse, delta, dO, softmax_scale,
                              kscale)
    return torch.bmm(dS.transpose(1, 2), Qf)


def attention_core_bwd_joint_reference(Q, K, V, keep, lse, delta, dO,
                                       softmax_scale: float = 10.0,
                                       kscale=None):
    """Plain version of the joint backward, in float32: P and dS formed
    once, then (dQ = dS K_eff, dK_eff = dS^T Q, dV = P^T dO), the terms as
    in ``attention_core_dq_reference``."""
    P, dS, Qf, Kf = _bwd_terms(Q, K, V, keep, lse, delta, dO, softmax_scale,
                               kscale)
    return (torch.bmm(dS, Kf), torch.bmm(dS.transpose(1, 2), Qf),
            torch.bmm(P.transpose(1, 2), dO))


def attention_core_bwd_reference(Q, K, V, keep, out, lse, dO,
                                 softmax_scale: float = 10.0, kscale=None):
    """Plain version of the backward: delta = rowsum(dO O), then the joint
    backward's plain version. Returns (dQ, dK_eff, dV), float32."""
    delta = (dO * out).sum(-1)
    return attention_core_bwd_joint_reference(Q, K, V, keep, lse, delta, dO,
                                              softmax_scale, kscale)


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


def _kscale_or_ones(Q, kscale):
    if kscale is not None:
        return kscale
    return torch.ones((Q.shape[0], Q.shape[2]), dtype=torch.float32,
                      device=Q.device)


def _launch_bwd(name, Q, K, tensors, softmax_scale, extra=(), codes=()):
    """Launch the backward kernel ``name`` with Q's dtype code and the ints
    ``codes``, the data pointers of ``tensors`` in the C signature's order
    (None for a NULL pointer), the dimensions and the ints ``extra`` after
    them."""
    B, N, D = Q.shape
    P = K.shape[1]
    fn, err_str = _kernel(name)
    with torch.cuda.device(Q.device):  # a launch runs on the current device
        rc = fn(_DTYPE_CODES[Q.dtype], *codes,
                *(None if t is None else t.data_ptr() for t in tensors),
                B, N, P, D, *extra, float(softmax_scale),
                torch.cuda.current_stream(Q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"contextual_attention_{name} launch failed "
                           f"(B={B}, N={N}, P={P}, D={D}, {Q.dtype}): "
                           f"{err_str(rc).decode()}")


# --- the kernels as torch.library custom ops ---------------------------------
# Each op's CPU implementation is the plain version, its CUDA implementation
# the launch (counted), its fake implementation the output shapes.


def _with_lse(out, lse, like):
    """(out, lse), an empty float32 lse standing for a forward that was not
    asked for one."""
    if lse is None:
        lse = like.new_empty((0,), dtype=torch.float32)
    return out, lse


def _fwd_fake(Q, out_dtype, return_lse):
    return (Q.new_empty(Q.shape, dtype=out_dtype),
            Q.new_empty(Q.shape[:2] if return_lse else (0,),
                        dtype=torch.float32))


def _forward_op(name: str, plain, counter: str):
    """The forward op ``sketchedit::attention_<name>`` over (Q, K, V, keep,
    kscale, softmax_scale, out_dtype, return_lse) -> (out, lse)."""

    def cpu(Q: Tensor, K: Tensor, V: Tensor, keep: Tensor,
            kscale: Optional[Tensor], softmax_scale: float,
            out_dtype: torch.dtype, return_lse: bool) -> tuple[Tensor, Tensor]:
        res = plain(Q, K, V, keep, softmax_scale, return_lse, out_dtype,
                    kscale)
        return res if return_lse else _with_lse(res, None, Q)

    op = torch.library.custom_op(f"sketchedit::attention_{name}", cpu,
                                 mutates_args=(), device_types="cpu")

    @op.register_kernel("cuda")
    def _(Q, K, V, keep, kscale, softmax_scale, out_dtype, return_lse):
        out, lse = _forward_on_device(name, Q, K, V, keep, softmax_scale,
                                      return_lse, out_dtype, kscale)
        _count(counter)
        return _with_lse(out, lse, Q)

    op.register_fake(lambda Q, K, V, keep, kscale, softmax_scale, out_dtype,
                     return_lse: _fwd_fake(Q, out_dtype, return_lse))
    return op


_fwd_op = _forward_op("fwd", attention_core_reference, "LAUNCHES")
_fwd_dsplit_op = _forward_op("fwd_dsplit", attention_core_dsplit_reference,
                             "LAUNCHES_DSPLIT")


@torch.library.custom_op("sketchedit::attention_fwd_shared", mutates_args=(),
                         device_types="cpu")
def _fwd_shared_op(V: Tensor, kscale: Tensor, keep: Tensor,
                   softmax_scale: float, out_dtype: torch.dtype,
                   return_lse: bool) -> tuple[Tensor, Tensor]:
    res = attention_core_shared_reference(V, kscale, keep, softmax_scale,
                                          return_lse, out_dtype)
    return res if return_lse else _with_lse(res, None, V)


@_fwd_shared_op.register_kernel("cuda")
def _(V, kscale, keep, softmax_scale, out_dtype, return_lse):
    out, lse = _forward_on_device("fwd_shared", V, V, V, keep, softmax_scale,
                                  return_lse, out_dtype, kscale)
    _count("LAUNCHES_SHARED")
    return _with_lse(out, lse, V)


@_fwd_shared_op.register_fake
def _(V, kscale, keep, softmax_scale, out_dtype, return_lse):
    return _fwd_fake(V, out_dtype, return_lse)


def _f32_like(*tensors):
    """Empty float32 tensors shaped like ``tensors``, on their device."""
    out = [t.new_empty(t.shape, dtype=torch.float32) for t in tensors]
    return out[0] if len(out) == 1 else tuple(out)


def _backward_op(name: str, cpu, fake):
    """The backward op ``sketchedit::attention_<name>``: ``cpu``, the plain
    version, whose annotations make the schema; ``fake`` the outputs'
    shapes. Its CUDA implementation is registered below."""
    op = torch.library.custom_op(f"sketchedit::attention_{name}", cpu,
                                 mutates_args=(), device_types="cpu")
    op.register_fake(fake)
    return op


def _dq_cpu(Q: Tensor, K: Tensor, V: Tensor, keep: Tensor, lse: Tensor,
            delta: Tensor, dO: Tensor, softmax_scale: float,
            kscale: Optional[Tensor]) -> Tensor:
    return attention_core_dq_reference(Q, K, V, keep, lse, delta, dO,
                                       softmax_scale, kscale)


def _dkdv_cpu(Q: Tensor, K: Tensor, V: Tensor, keep: Tensor, lse: Tensor,
              delta: Tensor, dO: Tensor, softmax_scale: float,
              kscale: Optional[Tensor]) -> tuple[Tensor, Tensor]:
    return attention_core_dkdv_reference(Q, K, V, keep, lse, delta, dO,
                                         softmax_scale, kscale)


def _bwd_cpu(Q: Tensor, K: Tensor, V: Tensor, keep: Tensor, lse: Tensor,
             delta: Tensor, dO: Tensor, softmax_scale: float,
             kscale: Optional[Tensor]) -> tuple[Tensor, Tensor, Tensor]:
    return attention_core_bwd_joint_reference(Q, K, V, keep, lse, delta, dO,
                                              softmax_scale, kscale)


def _dv_cpu(Q: Tensor, K: Tensor, keep: Tensor, lse: Tensor, dO: Tensor,
            softmax_scale: float, kscale: Optional[Tensor]) -> Tensor:
    return attention_core_dv_reference(Q, K, keep, lse, dO, softmax_scale,
                                       kscale)


def _dk_cpu(Q: Tensor, K: Tensor, V: Tensor, keep: Tensor, lse: Tensor,
            delta: Tensor, dO: Tensor, softmax_scale: float,
            kscale: Optional[Tensor]) -> Tensor:
    return attention_core_dk_reference(Q, K, V, keep, lse, delta, dO,
                                       softmax_scale, kscale)


_dq_op = _backward_op("dq", _dq_cpu, lambda Q, *_: _f32_like(Q))
_dkdv_op = _backward_op("dkdv", _dkdv_cpu, lambda Q, K, *_: _f32_like(K, K))
_bwd_op = _backward_op("bwd", _bwd_cpu, lambda Q, K, *_: _f32_like(Q, K, K))
_dv_op = _backward_op("dv", _dv_cpu, lambda Q, K, *_: _f32_like(K))
_dk_op = _backward_op("dk", _dk_cpu, lambda Q, K, *_: _f32_like(K))


# the CUDA implementations: the C signatures' pointers in their order
@_dq_op.register_kernel("cuda")
def _(Q, K, V, keep, lse, delta, dO, softmax_scale, kscale):
    dQ = _f32_like(Q)
    B, N, D = Q.shape
    nbytes, rows = dq_scratch(B, N, K.shape[1], D, Q.dtype,
                              K.data_ptr() == V.data_ptr())
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=Q.device)
    _launch_bwd("dq", Q, K, (Q, K, V, keep, _kscale_or_ones(Q, kscale), dO,
                             lse, delta, dQ, scratch), softmax_scale, (rows,))
    _count("LAUNCHES_DQ")
    return dQ


def _launch_grad(op, Q, K, V, keep, lse, delta, dO, softmax_scale, kscale,
                 dQ=None, dK=None, dV=None):
    """Launch the backward sequence with backward op ``op``'s mask on its
    own scratch: V and delta may be None where the mask forms no dP (dV
    alone), and so may the outputs it leaves out."""
    mask = _GRAD_MASKS[op]
    B, N, D = Q.shape
    same = V is None or K.data_ptr() == V.data_ptr()
    nbytes, rows = _grad_scratch(mask, B, N, K.shape[1], D, Q.dtype, same,
                                 None)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=Q.device)
    _launch_bwd("grad", Q, K, (Q, K, V, keep, _kscale_or_ones(Q, kscale), dO,
                               lse, delta, dQ, dK, dV, scratch),
                softmax_scale, (rows,), (mask,))


@_dkdv_op.register_kernel("cuda")
def _(Q, K, V, keep, lse, delta, dO, softmax_scale, kscale):
    dK, dV = _f32_like(K, K)
    _launch_grad("dkdv", Q, K, V, keep, lse, delta, dO, softmax_scale, kscale,
                 dK=dK, dV=dV)
    _count("LAUNCHES_DKDV")
    return dK, dV


@_bwd_op.register_kernel("cuda")
def _(Q, K, V, keep, lse, delta, dO, softmax_scale, kscale):
    dQ, dK, dV = _f32_like(Q, K, K)
    _launch_grad("bwd", Q, K, V, keep, lse, delta, dO, softmax_scale, kscale,
                 dQ, dK, dV)
    _count("LAUNCHES_BWD")
    return dQ, dK, dV


@_dv_op.register_kernel("cuda")
def _(Q, K, keep, lse, dO, softmax_scale, kscale):
    dV = _f32_like(K)
    _launch_grad("dv", Q, K, None, keep, lse, None, dO, softmax_scale, kscale,
                 dV=dV)
    _count("LAUNCHES_DV")
    return dV


@_dk_op.register_kernel("cuda")
def _(Q, K, V, keep, lse, delta, dO, softmax_scale, kscale):
    dK = _f32_like(K)
    _launch_grad("dk", Q, K, V, keep, lse, delta, dO, softmax_scale, kscale,
                 dK=dK)
    _count("LAUNCHES_DK")
    return dK


OPS = (_fwd_op, _fwd_shared_op, _fwd_dsplit_op, _dq_op, _dkdv_op, _bwd_op,
       _dv_op, _dk_op)


def attention_core_dq(Q, K, V, keep, lse, delta, dO,
                      softmax_scale: float = 10.0, kscale=None):
    """dQ (float32) of ``attention_core``, given the forward's logsumexp,
    delta = rowsum(dO O) and the float32 output gradient dO. A CUDA tensor
    launches dQ's sequence (split copies, then per chunk of query rows S,
    dP, the weights and dQ = dS K, the products on TMA-fed ``wgmma``;
    needs sm_90a; ``dq_plan`` says how it runs a shape); a CPU tensor takes
    the plain version."""
    _check_bwd(Q, K, V, keep, lse, delta, dO, kscale)
    return _dq_op(Q, K, V, keep, lse, delta, dO, float(softmax_scale), kscale)


def attention_core_dkdv(Q, K, V, keep, lse, delta, dO,
                        softmax_scale: float = 10.0, kscale=None):
    """(dK_eff, dV), float32, of ``attention_core``: dK_eff is the gradient
    of the keys K * kscale. A CUDA tensor launches the fused dK/dV's
    sequence (split copies, then per chunk of key rows S, dP, the weights,
    dV and dK, the products on TMA-fed ``wgmma``; needs sm_90a;
    ``dkdv_plan`` says how it runs a shape); a CPU tensor takes the plain
    version."""
    _check_bwd(Q, K, V, keep, lse, delta, dO, kscale)
    return _dkdv_op(Q, K, V, keep, lse, delta, dO, float(softmax_scale),
                    kscale)


def attention_core_bwd_joint(Q, K, V, keep, lse, delta, dO,
                             softmax_scale: float = 10.0, kscale=None):
    """(dQ, dK_eff, dV), float32, of ``attention_core`` from one sequence.
    A CUDA tensor launches the joint backward (the fused dK/dV's split
    copies and K transposed, then per chunk of key rows S, dP, the weights
    (P^T, dS^T and dS by rows), dV, dK and dQ += dS K, the products on
    TMA-fed ``wgmma``; needs sm_90a; ``bwd_plan`` says how it runs a
    shape); a CPU tensor takes the plain version."""
    _check_bwd(Q, K, V, keep, lse, delta, dO, kscale)
    return _bwd_op(Q, K, V, keep, lse, delta, dO, float(softmax_scale),
                   kscale)


def attention_core_dv(Q, K, keep, lse, dO, softmax_scale: float = 10.0,
                      kscale=None):
    """dV (float32) of ``attention_core`` alone: it needs neither V nor
    delta. A CUDA tensor launches the backward sequence with dV alone in
    its mask (split copies of K, Q kscale and dO transposed, then per chunk
    of key rows S, the weights pass forming P^T and dV = P^T dO; the joint
    backward's dV bit for bit; ``dk_dv_plan`` says how it runs a shape); a
    CPU tensor takes the plain version."""
    # V and delta are not read: K and lse stand in for them in the checks
    _check_bwd(Q, K, K, keep, lse, lse, dO, kscale)
    return _dv_op(Q, K, keep, lse, dO, float(softmax_scale), kscale)


def attention_core_dk(Q, K, V, keep, lse, delta, dO,
                      softmax_scale: float = 10.0, kscale=None):
    """dK_eff (float32) of ``attention_core`` alone, the gradient of the
    keys K * kscale. A CUDA tensor launches the backward sequence with dK
    alone in its mask (split copies of K, Q kscale, dO and Q transposed,
    then per chunk of key rows S, dP, the weights pass forming dS^T and
    dK_eff = dS^T Q; the joint backward's dK_eff bit for bit;
    ``dk_dv_plan`` says how it runs a shape); a CPU tensor takes the plain
    version."""
    _check_bwd(Q, K, V, keep, lse, delta, dO, kscale)
    return _dk_op(Q, K, V, keep, lse, delta, dO, float(softmax_scale), kscale)


def attention_core_bwd(Q, K, V, keep, out, lse, dO,
                       softmax_scale: float = 10.0, kscale=None):
    """Gradients of ``attention_core`` given its float32 output ``out``, its
    logsumexp ``lse`` and the float32 output gradient ``dO``: (dQ, dK_eff,
    dV), float32. delta = rowsum(dO O) is a plain reduction, as in the JAX
    package; then the joint backward or, under ``SKETCHEDIT_SPLIT_DKDV=1``,
    dQ's sequence and dV and dK alone (on the CPU, their plain
    versions)."""
    if out.dtype != torch.float32 or out.shape != dO.shape:
        raise ValueError(f"out must be float32 {tuple(dO.shape)}, got "
                         f"{out.dtype} {tuple(out.shape)}")
    delta = (dO * out).sum(-1)
    args = (Q, K, V, keep, lse, delta, dO, softmax_scale, kscale)
    if os.environ.get("SKETCHEDIT_SPLIT_DKDV") == "1":
        dQ = attention_core_dq(*args)
        dV = attention_core_dv(Q, K, keep, lse, dO, softmax_scale, kscale)
        return dQ, attention_core_dk(*args), dV
    return attention_core_bwd_joint(*args)


class ContextualAttentionCore(torch.autograd.Function):
    """``attention_core`` with a float32 output, differentiable in Q, K, V
    and kscale (the JAX package's ``custom_vjp``). The forward keeps the
    float32 output and the logsumexp; the backward runs
    ``attention_core_bwd`` and folds dK_eff back onto K and kscale in
    float32: dK = dK_eff * kscale, dkscale = sum_P dK_eff * K. keep gets no
    gradient (a threshold). When Q, K and V are one tensor (the main path),
    the three gradients are summed in float32 and returned once, which is
    the JAX package's ``_core_shared_bwd``; ``shared_kernel`` then sends the
    forward through ``attention_core_shared``."""

    @staticmethod
    def forward(ctx, Q, K, V, keep, kscale, softmax_scale,
                shared_kernel=False):
        ctx.softmax_scale = softmax_scale
        ctx.shared = Q is K and K is V
        if shared_kernel:
            assert ctx.shared, "the shared kernel takes one tensor"
            out, lse = attention_core_shared(
                V, kscale, keep, softmax_scale, return_lse=True,
                out_dtype=torch.float32)
        else:
            out, lse = attention_core(
                Q, K, V, keep, softmax_scale, return_lse=True,
                out_dtype=torch.float32, kscale=kscale)
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
            return ((dQ + dK + dV).to(V.dtype), None, None, None, dkscale,
                    None, None)
        return (dQ.to(Q.dtype), dK.to(K.dtype), dV.to(V.dtype), None,
                dkscale, None, None)


def attention_core_differentiable(Q, K, V, keep, softmax_scale: float = 10.0,
                                  kscale=None, shared_kernel: bool = False):
    """``attention_core`` with a float32 output through
    ``ContextualAttentionCore`` when autograd needs it; otherwise the plain
    call, which skips the logsumexp and saves nothing. ``shared_kernel``
    (Q, K and V are one tensor) takes ``attention_core_shared`` for the
    forward."""
    kscale = _kscale_or_ones(Q, kscale)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (Q, K, V, kscale)):
        return ContextualAttentionCore.apply(Q, K, V, keep, kscale,
                                             softmax_scale, shared_kernel)
    if shared_kernel:
        return attention_core_shared(V, kscale, keep, softmax_scale,
                                     out_dtype=torch.float32)
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


def forward_kernel(shared_tensor: bool = True) -> str:
    """The forward kernel that ``contextual_attention_fused`` takes under
    the environment's switches: 'shared' (``SKETCHEDIT_SHARED_ATTN=1``,
    where foreground and background are one tensor), else 'dsplit'
    (``SKETCHEDIT_DSPLIT_ATTN=1``), else 'default'."""
    if shared_tensor and os.environ.get("SKETCHEDIT_SHARED_ATTN") == "1":
        return "shared"
    if os.environ.get("SKETCHEDIT_DSPLIT_ATTN") == "1":
        return "dsplit"
    return "default"


def contextual_attention_fused(f, b, mask, *, patch_size: int = 4,
                               stride: int = 2, softmax_scale: float = 10.0,
                               th: float = 0.1):
    """Drop-in for ``ops.attention.contextual_attention`` that runs the
    quadratic part through ``attention_core``, differentiable through the
    backward kernels. NCHW in and out. As in the dense version, the keys
    are formed in float32 and the kernel's float32 output is folded in
    float32 and rounded once to the input dtype (the JAX package's Pallas
    path rounds K and the output to bfloat16).

    The forward kernel is chosen on every call as in the JAX package
    (``forward_kernel``): ``SKETCHEDIT_SHARED_ATTN=1`` takes the
    shared-tensor kernel where ``f is b``; otherwise
    ``SKETCHEDIT_DSPLIT_ATTN=1`` takes the D-split kernel (inference only);
    otherwise the default kernel. ``torch.export`` bakes the choice into
    its graph."""
    H, W = b.shape[2:]
    Q, V, keep, kscale = attention_inputs(f, b, mask, patch_size=patch_size,
                                          stride=stride, th=th)
    kernel = forward_kernel(f is b)
    if kernel == "dsplit":
        out = attention_core_dsplit(Q, V, V, keep, softmax_scale,
                                    out_dtype=torch.float32, kscale=kscale)
    else:
        out = attention_core_differentiable(
            Q, V, V, keep, softmax_scale, kscale=kscale,
            shared_kernel=kernel == "shared")
    return fold_patches(out, (H, W), patch_size, stride).to(f.dtype)
