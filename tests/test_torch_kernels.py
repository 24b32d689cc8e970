"""The contextual-attention CUDA kernel against its plain PyTorch version.

These need an NVIDIA GPU and nvcc, so they carry the ``gpu`` marker and
skip elsewhere; chip_smoke.py holds the kernel to the same plain version on
the card at the main path's shapes. Run on a GPU machine with

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu -q

Tolerances: float32 rtol = atol = 1e-4 (summation order); bfloat16
rtol = atol = 2e-2 against the plain version fed the same bf16-rounded
inputs in float32 (the output is rounded to bf16).
"""

import numpy as np
import pytest
import torch

from sketchedit_tpu_torch.ops import attention_cuda
from sketchedit_tpu_torch.ops.attention import contextual_attention
from sketchedit_tpu_torch.ops.attention_cuda import (
    attention_core, attention_core_reference, contextual_attention_fused)

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
    tolerance, since nothing is rounded to bf16 on either side."""
    Q, _, V, keep = _inputs(5, 2, 96, 96, 160, 0.8, dtype, cuda)
    kscale = torch.rand(2, 160, device=cuda) + 0.5
    out = attention_core(V, V, V, keep, out_dtype=torch.float32,
                         kscale=kscale)
    torch.cuda.synchronize()
    want = attention_core_reference(V.float(), V.float(), V.float(), keep,
                                    kscale=kscale)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, want, **TOL[torch.float32])


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
