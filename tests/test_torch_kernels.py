"""The contextual-attention CUDA kernels (forward, dQ and dK/dV) against
their plain PyTorch versions, and the kernel path's gradient against dense
autograd.

These need an NVIDIA GPU and nvcc, so they carry the ``gpu`` marker and
skip elsewhere; chip_smoke.py holds the kernel to the same plain version on
the card at the main path's shapes. Run on a GPU machine with

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu -q

Tolerances: forward float32 rtol = atol = 1e-4 (summation order);
bfloat16 rtol = atol = 2e-2 against the plain version fed the same
bf16-rounded inputs in float32 (the output is rounded to bf16). Backward:
2e-4 of each gradient's max |value|, for both input types (float32
arithmetic and outputs on both sides, S recomputed in another order);
the kernel path's gradient against dense autograd: 1e-3 of its max.
"""

import numpy as np
import pytest
import torch

from sketchedit_tpu_torch.ops import attention_cuda
from sketchedit_tpu_torch.ops.attention import contextual_attention
from sketchedit_tpu_torch.ops.attention_cuda import (
    attention_core, attention_core_dkdv, attention_core_dkdv_reference,
    attention_core_dq, attention_core_dq_reference, attention_core_reference,
    contextual_attention_fused)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on "
                    "the card")
    return torch.device("cuda")


def _inputs(seed, B, N, P, D, keep_p, dtype, device):
    rs = np.random.RandomState(seed)
    # Q / sqrt(D) keeps the logits near 10 in spread, as in the model
    Q, K, V = (torch.from_numpy((rs.randn(B, n, D) * s).astype(np.float32)
                                ).to(device, dtype)
               for n, s in ((N, D ** -0.5), (P, 1.0), (P, 1.0)))
    keep = torch.from_numpy((rs.rand(B, P) < keep_p).astype(np.float32))
    return Q, K, V, keep.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,keep_p", [
    ((2, 130, 150, 70), 0.7),         # ragged N, P and D
    ((1, 17, 65, 33), 0.5),           # one key past a tile, odd D
    ((1, 40, 64, 1536), 0.0),         # all gated: the uniform mean of V
    ((3, 300, 200, 600), 0.9),
])
def test_kernel_matches_plain(cuda, dtype, shape, keep_p):
    Q, K, V, keep = _inputs(sum(shape), *shape, keep_p, dtype, cuda)
    before = attention_cuda.LAUNCHES
    out, lse = attention_core(Q, K, V, keep, return_lse=True)
    torch.cuda.synchronize()
    assert attention_cuda.LAUNCHES == before + 1
    want, want_lse = attention_core_reference(Q, K, V, keep, return_lse=True)
    assert out.dtype == dtype and out.shape == Q.shape
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_kscale_float32_out(cuda, dtype):
    """The main path's call: K = V, per-channel kscale, float32 output; held
    to the plain version on the same (bf16-rounded) inputs at float32
    tolerance, since nothing is rounded to bf16 on either side. kscale
    carries 1/sqrt(D), as the background's inverse norm does on the path,
    so the logits spread as in the model; unscaled, the logits of unit-
    variance V reach ~10^3, and two near-tied keys of a gated query differ
    between summation orders by about the tolerance."""
    Q, _, V, keep = _inputs(5, 2, 96, 96, 160, 0.8, dtype, cuda)
    kscale = ((torch.rand(2, 160, generator=torch.Generator().manual_seed(5))
               + 0.5) * 160 ** -0.5).to(cuda)
    out = attention_core(V, V, V, keep, out_dtype=torch.float32,
                         kscale=kscale)
    torch.cuda.synchronize()
    want = attention_core_reference(V.float(), V.float(), V.float(), keep,
                                    kscale=kscale)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, want, **TOL[torch.float32])


SHAPES = [
    ((2, 130, 150, 70), 0.7),         # ragged N, P and D
    ((1, 17, 65, 33), 0.5),           # one key past a tile, odd D
    ((1, 40, 64, 1536), 0.0),         # all gated: dQ = dK = 0
    ((3, 300, 200, 600), 0.9),
    ((16, 140, 175, 100), 0.7),       # enough tiles for 16-row dQ and dK/dV
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,keep_p", SHAPES)
def test_bwd_kernels_match_plain(cuda, dtype, shape, keep_p):
    Q, K, V, keep = _inputs(sum(shape) + 1, *shape, keep_p, dtype, cuda)
    rs = np.random.RandomState(sum(shape))
    B, N, _, D = shape
    dO = torch.from_numpy(rs.randn(B, N, D).astype(np.float32)).to(cuda)
    kscale = torch.from_numpy((0.5 + rs.rand(B, D)).astype(np.float32)
                              ).to(cuda)
    out, lse = attention_core(Q, K, V, keep, return_lse=True,
                              out_dtype=torch.float32, kscale=kscale)
    args = (Q, K, V, keep, lse, (dO * out).sum(-1), dO, 10.0, kscale)
    before = (attention_cuda.LAUNCHES_DQ, attention_cuda.LAUNCHES_DKDV)
    got = (attention_core_dq(*args), *attention_core_dkdv(*args))
    torch.cuda.synchronize()
    assert (attention_cuda.LAUNCHES_DQ, attention_cuda.LAUNCHES_DKDV) == (
        before[0] + 1, before[1] + 1)
    want = (attention_core_dq_reference(*args),
            *attention_core_dkdv_reference(*args))
    for name, g, w in zip(("dQ", "dK_eff", "dV"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = max(w.abs().max().item(), 1e-6)
        torch.testing.assert_close(g, w, rtol=0, atol=2e-4 * scale,
                                   msg=lambda m, n=name: f"{n}: {m}")


def test_fused_gradient_matches_dense_autograd(cuda):
    """The kernel path's autograd (ContextualAttentionCore: forward with
    lse, one dQ and one dK/dV launch) against dense autograd."""
    rs = np.random.RandomState(1)
    f = torch.from_numpy(np.maximum(rs.randn(2, 96, 32, 32), 0).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy((rs.rand(2, 1, 32, 32) > 0.5).astype(np.float32)
                            ).to(cuda)
    grads = []
    for fn in (contextual_attention_fused, contextual_attention):
        x = f.clone().requires_grad_()
        before = (attention_cuda.LAUNCHES_LSE, attention_cuda.LAUNCHES_DQ,
                  attention_cuda.LAUNCHES_DKDV)
        out = fn(x, x, mask)
        assert out.grad_fn is not None
        grads.append(torch.autograd.grad((out ** 2).sum(), x)[0])
        after = (attention_cuda.LAUNCHES_LSE, attention_cuda.LAUNCHES_DQ,
                 attention_cuda.LAUNCHES_DKDV)
        want = 1 if fn is contextual_attention_fused else 0
        assert after == tuple(b + want for b in before)
    scale = grads[1].abs().max().item()
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-3 * scale)


def test_fused_contextual_attention_matches_dense(cuda):
    rs = np.random.RandomState(0)
    f = torch.from_numpy(rs.randn(2, 96, 32, 32).astype(np.float32)).to(cuda)
    mask = torch.from_numpy((rs.rand(2, 1, 32, 32) > 0.5).astype(np.float32)
                            ).to(cuda)
    got = contextual_attention_fused(f, f, mask)
    torch.testing.assert_close(got, contextual_attention(f, f, mask),
                               **TOL[torch.float32])


def test_kernel_rejects_cpu_mix(cuda):
    Q, K, V, keep = _inputs(0, 1, 8, 8, 8, 1.0, torch.float32, cuda)
    with pytest.raises(ValueError):
        attention_core(Q, K, V, keep.cpu())
