"""The port's image metrics (``sketchedit_tpu_torch/utils/metrics.py``)
against the JAX package's on the same seeded inputs, float32 and bfloat16,
rtol 1e-5 / atol 1e-6; SSIM's size check, an empty mask, and SSIM's filter
running with TF32 off whatever the global setting."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sketchedit_tpu.utils import metrics as j_metrics
from sketchedit_tpu_torch.utils import metrics as t_metrics

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed, hw=48, b=3):
    rs = np.random.RandomState(seed)
    a = rs.uniform(-1, 1, (b, hw, hw, 3)).astype(np.float32)
    # b: a degraded a, so PSNR and SSIM sit in their working ranges
    noisy = a + rs.normal(0, 0.1, a.shape).astype(np.float32)
    noisy[:, hw // 4:hw // 2] = rs.uniform(-1, 1, (b, hw // 4, hw, 3))
    mask = np.zeros((b, hw, hw, 1), np.float32)
    mask[:, hw // 4:3 * hw // 4, hw // 8:hw // 2] = 1.0
    mask[0] = 0.0                              # one image with no region
    mask[1, 0, 0] = 0.5                        # on the threshold: outside
    return a, noisy.astype(np.float32), mask


def _both(x, dtype):
    if dtype == "bfloat16":
        return (torch.from_numpy(x).bfloat16(),
                jnp.asarray(x).astype(jnp.bfloat16))
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["psnr", "masked_psnr", "masked_l1",
                                  "ssim", "ssim_k"])
def test_metric_matches_jax(name, dtype):
    a, b, mask = _inputs(0)
    (ta, ja), (tb, jb) = _both(a, dtype), _both(b, dtype)
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    if name in ("psnr", "ssim"):
        got = getattr(t_metrics, name)(ta, tb)
        want = getattr(j_metrics, name)(ja, jb)
    elif name == "ssim_k":                      # non-default constants
        kw = dict(data_range=1.0, window_size=7, sigma=1.0, k1=0.02, k2=0.05)
        got, want = t_metrics.ssim(ta, tb, **kw), j_metrics.ssim(ja, jb, **kw)
    else:
        got = getattr(t_metrics, name)(ta, tb, tm)
        want = getattr(j_metrics, name)(ja, jb, jm)
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_ssim_needs_the_window():
    x = torch.zeros(1, 10, 32, 3)
    with pytest.raises(ValueError, match="ssim needs"):
        t_metrics.ssim(x, x)
    with pytest.raises(ValueError, match="ssim needs"):
        t_metrics.ssim(x.transpose(1, 2), x.transpose(1, 2))


def test_empty_mask_stays_finite():
    a, b, _ = _inputs(1, hw=16, b=2)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    empty = torch.zeros(2, 16, 16, 1)
    p = t_metrics.masked_psnr(ta, tb, empty)
    l1 = t_metrics.masked_l1(ta, tb, empty)
    assert torch.isfinite(p).all() and torch.isfinite(l1).all()
    np.testing.assert_allclose(p.numpy(), 10 * np.log10(4.0 / 1e-12),
                               rtol=1e-6)
    assert (l1 == 0).all()
    # identical images: the 1e-12 floor, not +inf
    assert torch.isfinite(t_metrics.psnr(ta, ta)).all()


def test_ssim_filter_runs_without_tf32(monkeypatch):
    seen = []
    conv2d = t_metrics.F.conv2d

    def spy(*args, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kw)

    monkeypatch.setattr(t_metrics.F, "conv2d", spy)
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        a, b, _ = _inputs(2, hw=16, b=2)
        t_metrics.ssim(torch.from_numpy(a), torch.from_numpy(b))
        assert seen == [False] * 5
        assert torch.backends.cudnn.allow_tf32 is True     # restored
    finally:
        torch.backends.cudnn.allow_tf32 = saved
