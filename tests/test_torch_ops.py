"""Port ops (sketchedit_tpu_torch.ops, NCHW) against their JAX counterparts
(NHWC) on the same numpy inputs, on the CPU. Tolerance rtol = atol = 1e-5:
float32 on both sides, only the summation order differs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sketchedit_tpu.ops import attention as jattn
from sketchedit_tpu.ops import gated_conv as jgc
from sketchedit_tpu.ops import image as jimage
from sketchedit_tpu_torch.ops import attention as tattn
from sketchedit_tpu_torch.ops import gated_conv as tgc
from sketchedit_tpu_torch.ops import image as timage

TOL = dict(rtol=1e-5, atol=1e-5)


def nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _conv_params(rs, cin, cout, k):
    w = (rs.randn(k, k, cin, cout) * np.sqrt(2.0 / (cin * k * k))).astype(
        np.float32)
    b = (rs.randn(cout) * 0.1).astype(np.float32)
    return w, b


def _torch_wb(w, b):
    return (torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
            torch.from_numpy(b))


def test_conv2d_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 17, 19, 5).astype(np.float32)
    w, b = _conv_params(rs, 5, 6, 5)
    want = np.asarray(jgc.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                 jnp.asarray(x), stride=1, rate=1))
    got = nhwc(tgc.conv2d(nchw(x), *_torch_wb(w, b), stride=1, rate=1))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stride,rate,cout,act", [
    (2, 1, 8, "elu"),        # stride-2 downsample
    (1, 2, 8, "elu"),
    (1, 16, 8, "elu"),       # the widest dilation of the nets
    (1, 1, 8, "relu"),       # pmconv6
    (1, 1, 3, "elu"),        # cout 3: never gated
    (1, 1, 4, None),         # activation None: never gated
])
def test_gated_conv2d_matches_jax(stride, rate, cout, act):
    rs = np.random.RandomState(stride * 100 + rate + cout)
    x = rs.randn(2, 20, 24, 4).astype(np.float32)
    w, b = _conv_params(rs, 4, cout, 3)
    want = np.asarray(jgc.gated_conv2d(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
        stride=stride, rate=rate, activation=act))
    got = nhwc(tgc.gated_conv2d(nchw(x), *_torch_wb(w, b), stride=stride,
                                rate=rate, activation=act))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cout,act", [(8, "elu"), (3, None)])
def test_gated_deconv2d_matches_jax(cout, act):
    rs = np.random.RandomState(cout)
    x = rs.randn(2, 9, 11, 6).astype(np.float32)
    w, b = _conv_params(rs, 6, cout, 3)
    want = np.asarray(jgc.gated_deconv2d(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
        activation=act))
    got = nhwc(tgc.gated_deconv2d(nchw(x), *_torch_wb(w, b), activation=act))
    assert got.shape == want.shape == (2, 18, 22, cout if act is None
                                       else cout // 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stride,slope", [(2, 0.2), (1, 0.01)])
def test_leaky_conv2d_matches_jax(stride, slope):
    """The discriminator's 5x5 conv + leaky-relu (slope 0.2 there)."""
    rs = np.random.RandomState(stride)
    x = rs.randn(2, 17, 20, 7).astype(np.float32)
    w, b = _conv_params(rs, 7, 8, 5)
    want = np.asarray(jgc.leaky_conv2d(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
        stride=stride, negative_slope=slope))
    got = nhwc(tgc.leaky_conv2d(nchw(x), *_torch_wb(w, b), stride=stride,
                                negative_slope=slope))
    assert got.shape == want.shape
    assert (want < 0).any()
    np.testing.assert_allclose(got, want, **TOL)


def test_gaussian_blur3x3_matches_jax():
    rs = np.random.RandomState(5)
    x = rs.uniform(-1, 1, (2, 13, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        nhwc(timage.gaussian_blur3x3(nchw(x))),
        np.asarray(jimage.gaussian_blur3x3(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("cin,cout", [(4, 8), (1, 16)])
def test_orthogonal_init_is_orthogonal(cin, cout):
    """init_type 'orthogonal', as init_conv_params builds it: the (cout,
    cin*k*k) weight matrix has orthonormal rows (or columns when cout is the
    larger side) scaled by the gain, and a zero bias."""
    conv = tgc.GatedConv2d(cin, cout, 3, stride=1, rate=1, activation=None)
    tgc.init_conv_(conv, torch.Generator().manual_seed(0),
                   init_type="orthogonal", gain=0.5)
    m = conv.weight.detach().reshape(cout, -1).double()
    gram = m @ m.T if cout <= m.shape[1] else m.T @ m
    torch.testing.assert_close(gram, 0.25 * torch.eye(gram.shape[0],
                                                      dtype=torch.float64),
                               rtol=0, atol=1e-6)
    assert not conv.bias.any()


def test_gated_conv_module_matches_function():
    """The nn.Module form runs the same math and keeps the reference's
    padding and dilation."""
    rs = np.random.RandomState(3)
    x = rs.randn(1, 16, 16, 4).astype(np.float32)
    conv = tgc.GatedConv2d(4, 8, 3, stride=1, rate=4, activation="elu")
    with torch.no_grad():
        got = conv(nchw(x))
        want = tgc.gated_conv2d(nchw(x), conv.weight, conv.bias, rate=4)
    assert conv.padding == (4, 4) and conv.dilation == (4, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_avg_pool_and_upsample_match_jax():
    rs = np.random.RandomState(4)
    x = rs.rand(2, 16, 20, 1).astype(np.float32)
    np.testing.assert_allclose(nhwc(timage.avg_pool2d(nchw(x), 4, 4)),
                               np.asarray(jimage.avg_pool2d(jnp.asarray(x), 4, 4)),
                               **TOL)
    np.testing.assert_array_equal(
        nhwc(timage.nearest_upsample2x(nchw(x))),
        np.asarray(jimage.nearest_upsample2x(jnp.asarray(x))))


def _jax_patches_as_port(p):
    """(B, nh, nw, k, k, C) -> (B, L, C*k*k), the port's (c, ky, kx) order."""
    B, nh, nw, k, _, C = p.shape
    return np.ascontiguousarray(
        p.reshape(B, nh * nw, k, k, C).transpose(0, 1, 4, 2, 3)
    ).reshape(B, nh * nw, C * k * k)


@pytest.mark.parametrize("hw", [(16, 16), (18, 22)])
def test_patches_fold_and_valid_ratio_match_jax(hw):
    rs = np.random.RandomState(hw[1])
    H, W = hw
    x = rs.randn(2, H, W, 3).astype(np.float32)
    jp = np.asarray(jattn.extract_patches(jnp.asarray(x), 4, 2))
    tp = tattn.extract_patches(nchw(x), 4, 2).numpy()
    np.testing.assert_array_equal(tp, _jax_patches_as_port(jp))

    patches = rs.randn(*jp.shape).astype(np.float32)
    want = np.asarray(jattn.fold_patches(jnp.asarray(patches), (H, W), 2))
    got = nhwc(tattn.fold_patches(
        torch.from_numpy(_jax_patches_as_port(patches)), (H, W), 4, 2))
    np.testing.assert_allclose(got, want, **TOL)

    valid = (rs.rand(2, H, W, 1) > 0.4).astype(np.float32)
    np.testing.assert_allclose(
        tattn.patch_valid_ratio(nchw(valid), 4, 2).numpy(),
        np.asarray(jattn.patch_valid_ratio(jnp.asarray(valid), 4, 2)), **TOL)
