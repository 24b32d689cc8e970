"""The whole splitcam configuration space on the port against the JAX
package, on the CPU: ``ops.attention.splitcam_attention`` at the eight
reference configurations of tests/test_attention.py (out and the hole
reconstruction), a bfloat16 call, and netG at a non-released configuration
against the JAX netG, with a gradient smoke.

Tolerances, float32 on both sides (JAX at Precision.HIGHEST): the
attention rtol 1e-4 / atol 1e-5, as the repo's torch parity tests; netG
2e-4 (test_torch_parallel.py's), on tanh outputs of order 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sketchedit_tpu.models import deepfill_c2 as j_g
from sketchedit_tpu.ops import attention as j_att
from sketchedit_tpu_torch.models.deepfill_c2 import (
    DeepFillC2Generator, DeepFillConfig)
from sketchedit_tpu_torch.ops import attention_cuda
from sketchedit_tpu_torch.ops.attention import (
    SplitCAMConfig, splitcam_attention)
from sketchedit_tpu_torch.params.convert import jax_params_to_state_dict
from test_torch_edit import jax_params      # scaled kaiming weights

HIGH = jax.lax.Precision.HIGHEST
# tests/test_attention.py's variants: constructor overrides
VARIANTS = {
    "released": {},
    "nn_hard": {"nn_hard": True},
    "is_th_false": {"is_th": False},
    "mk_true": {"mk": True},
    "pd1": {"pd": 1},
    "norm_type2": {"norm_type": 2},
    # fuse needs the patch grid to equal (h/2, w/2): pd=1 gives it
    "fuse": {"pd": 1, "is_fuse": True},
    "everything": {"pd": 1, "is_fuse": True, "is_th": False, "mk": True,
                   "nn_hard": True, "norm_type": 2, "th": 0.3},
}
# netG's non-released configuration
NETG_ATTENTION = {"pd": 1, "mk": True, "nn_hard": True, "is_th": False}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the test runner puts several test files side
    by side on the host's cores, and these nets are small."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _features(seed=7, B=2, H=16, C=12):
    rs = np.random.RandomState(seed)
    f = rs.randn(B, H, H, C).astype(np.float32)
    mask = (rs.rand(B, H, H, 1) > 0.5).astype(np.float32)
    return f, mask


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_splitcam_matches_jax(name):
    f, mask = _features()
    want, want_w, want_recon = j_att.splitcam_attention(
        jnp.asarray(f), jnp.asarray(f), jnp.asarray(mask),
        j_att.SplitCAMConfig(**VARIANTS[name]), precision=HIGH,
        return_weights=True, return_recon=True)
    ft = nchw(f)
    got, got_w, got_recon = splitcam_attention(
        ft, ft, nchw(mask), SplitCAMConfig(**VARIANTS[name]),
        return_weights=True, return_recon=True)
    assert got.dtype == torch.float32 and got.shape == ft.shape
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(nhwc(got_recon), np.asarray(want_recon),
                               rtol=1e-4, atol=1e-5)
    assert np.asarray(want).std() > 0.1          # not a vacuous compare


def test_splitcam_released_is_the_dense_attention():
    """At the released configuration splitcam computes what the fast path
    (and so the kernels) computes."""
    from sketchedit_tpu_torch.ops.attention import contextual_attention
    f, mask = _features(3)
    ft, mt = nchw(f), nchw(mask)
    torch.testing.assert_close(splitcam_attention(ft, ft, mt),
                               contextual_attention(ft, ft, mt),
                               rtol=1e-5, atol=1e-5)


def test_splitcam_bfloat16_keeps_its_dtype():
    f, mask = _features(5)
    cfg = SplitCAMConfig(**VARIANTS["everything"])
    fb = nchw(f).bfloat16()
    got = splitcam_attention(fb, fb, nchw(mask), cfg)
    assert got.dtype == torch.bfloat16
    # float32 arithmetic on the bf16-rounded features, one rounding out
    want = splitcam_attention(fb.float(), fb.float(), nchw(mask), cfg)
    torch.testing.assert_close(got.float(), want.bfloat16().float(),
                               rtol=0, atol=0)


def _netg_inputs(seed=11, H=32):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-1, 1, (1, H, H, 3)).astype(np.float32)
    m = np.zeros((1, H, H, 1), np.float32)
    m[:, 8:24, 10:22] = 1.0
    guide = (rs.rand(1, H, H, 1) > 0.9).astype(np.float32)
    return x, m, guide


def _port_netg(params, impl="auto"):
    net = DeepFillC2Generator(DeepFillConfig(
        attention_impl=impl, attention=SplitCAMConfig(**NETG_ATTENTION)))
    net.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return net


def test_netg_non_released_attention_matches_jax():
    """netG at pd=1, mk, nn_hard and is_th=False against the JAX netG; the
    kernel route is overridden by the configuration, as in the JAX netG,
    so no kernel op runs."""
    params = jax_params(4)["G"]
    x, m, guide = _netg_inputs()
    want = j_g.apply(params, x, x, m, m, guide, precision=HIGH,
                     config=j_g.DeepFillConfig(
                         attention=j_att.SplitCAMConfig(**NETG_ATTENTION)))
    net = _port_netg(params, impl="kernel")
    assert net.config.attention_route("cuda") == "splitcam"
    before = attention_cuda.LAUNCHES
    with torch.no_grad():
        got = net(nchw(x), nchw(x), nchw(m), nchw(m), nchw(guide))
    assert attention_cuda.LAUNCHES == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
    assert np.asarray(want[1]).std() > 0.05
    # the configuration reaches the attention: the released netG differs
    released = j_g.apply(params, x, x, m, m, guide, precision=HIGH)
    assert np.abs(np.asarray(released[1]) - np.asarray(want[1])).max() > 1e-3


def test_netg_non_released_attention_gradients():
    """The gradient reaches the pm layers before the attention through the
    value patches (the hard weights carry none) and matches the JAX
    netG's."""
    params = jax_params(4)["G"]
    x, m, guide = _netg_inputs(12)
    cfg = j_g.DeepFillConfig(attention=j_att.SplitCAMConfig(**NETG_ATTENTION))

    def j_loss(p):
        s1, s2 = j_g.apply(p, x, x, m, m, guide, precision=HIGH, config=cfg)
        return jnp.abs(s2 - x).mean() + 0.5 * jnp.abs(s1 - x).mean()

    want = jax.grad(j_loss)(params)
    net = _port_netg(params)
    xt, mt = nchw(x), nchw(m)
    s1, s2 = net(xt, xt, mt, mt, nchw(guide))
    loss = (s2 - xt).abs().mean() + 0.5 * (s1 - xt).abs().mean()
    names = ("pmconv1", "pmconv6", "allconv17")
    grads = torch.autograd.grad(
        loss, [getattr(net, n).weight for n in names])
    for name, g in zip(names, grads):
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        w = np.asarray(want[name]["w"]).transpose(3, 2, 0, 1)   # HWIO -> OIHW
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-3 * np.abs(w).max())
