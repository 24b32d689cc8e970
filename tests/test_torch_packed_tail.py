"""The port's space-to-depth packed fronts and tails against the JAX
package's, on the CPU: each packed function and weight map, both policies,
netM and netG with ``pack`` on and off, the gradients through the packed
layers, the kept packed kernels, the edit and a packed export.

JAX runs at Precision.HIGHEST, torch in float32 with TF32 off; inputs come
from numpy with a seed. Tolerances: the JAX tests' own for the packed
functions (tests/test_packed_tail.py: the tails rtol/atol 1e-5 and rtol
1e-4 / atol 1e-5, the front 1e-5); the weight maps exact to 1e-6 (a sum of
at most four float32 taps); the nets atol 1e-4 and the edit 1 LSB, as
tests/test_torch_models.py and tests/test_torch_edit.py hold them; the
packed gradients within relative L2 1e-5 of the plain ones (the same
float32 arithmetic in another summation order).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sketchedit_tpu.models import deepfill_c2 as j_g
from sketchedit_tpu.models import editline2 as j_e
from sketchedit_tpu.models import md_generator as j_m
from sketchedit_tpu.ops import gated_conv as j_gc
from sketchedit_tpu.ops import packed_tail as j_pt
from sketchedit_tpu_torch.models import editline2 as t_e
from sketchedit_tpu_torch.models.deepfill_c2 import (
    DeepFillC2Generator, DeepFillConfig)
from sketchedit_tpu_torch.models.md_generator import MDGenerator
from sketchedit_tpu_torch.ops import packed_tail as t_pt
from sketchedit_tpu_torch.ops.gated_conv import GatedConv2d
from sketchedit_tpu_torch.parallel import distributed
from sketchedit_tpu_torch.params.convert import jax_params_to_state_dict
from sketchedit_tpu_torch.server.artifact import (
    export_edit_artifact, load_edit_artifact)
from test_torch_edit import jax_params, port_model, u8_inputs
from test_torch_models import (
    GAIN_G, GAIN_M, _inputs, nchw, nhwc, scaled_params)

HI = jax.lax.Precision.HIGHEST


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads (test files run side by side) and no TF32."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_pack_env(monkeypatch):
    monkeypatch.delenv("SKETCHEDIT_PACK", raising=False)
    monkeypatch.delenv("SKETCHEDIT_PACK_MID", raising=False)


def _p(key, cin, cout, k=3):
    return j_gc.init_conv_params(key, cin, cout, k, init_type="kaiming",
                                 dtype=jnp.float32)


def _layer(p, activation="elu", stride=1):
    """A GatedConv2d holding the JAX layer's (HWIO) weights as OIHW."""
    w = np.asarray(p["w"])
    layer = GatedConv2d(w.shape[2], w.shape[3], w.shape[0], stride, 1,
                        activation)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        layer.bias.copy_(torch.from_numpy(np.asarray(p["b"])))
    return layer


def test_packed_decoder_tail_matches_jax():
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    p_up, p_mid, p_head = _p(ks[0], 24, 24), _p(ks[1], 12, 12), _p(ks[2], 6, 3)
    x = np.random.RandomState(0).randn(2, 8, 8, 24).astype(np.float32)
    want = j_pt.packed_decoder_tail(p_up, p_mid, p_head, jnp.asarray(x),
                                    precision=HI)
    with torch.no_grad():
        got = t_pt.packed_decoder_tail(_layer(p_up), _layer(p_mid),
                                       _layer(p_head, None), nchw(x))
    assert got.shape == (2, 3, 16, 16)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_packed_decoder_tail5_matches_jax():
    """deepfill's tail widths: 96->96 (up), 48->96, 48->48 (up), 24->24,
    12->3, through the double-packed deconv."""
    ks = jax.random.split(jax.random.PRNGKey(1), 5)
    ps = [_p(ks[0], 96, 96), _p(ks[1], 48, 96), _p(ks[2], 48, 48),
          _p(ks[3], 24, 24), _p(ks[4], 12, 3)]
    x = np.random.RandomState(1).randn(2, 8, 8, 96).astype(np.float32)
    want = j_pt.packed_decoder_tail5(*ps, jnp.asarray(x), precision=HI)
    layers = [_layer(p) for p in ps[:-1]] + [_layer(ps[-1], None)]
    with torch.no_grad():
        got = t_pt.packed_decoder_tail5(*layers, nchw(x))
    assert got.shape == (2, 3, 32, 32)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("k1", [3, 5])
def test_packed_encoder_front_matches_jax(k1):
    ks = jax.random.split(jax.random.PRNGKey(2), 2)
    p1, p2 = _p(ks[0], 4, 48, k=k1), _p(ks[1], 24, 96)
    x = np.random.RandomState(2).randn(2, 16, 16, 4).astype(np.float32)
    want = j_pt.packed_encoder_front(p1, p2, jnp.asarray(x), precision=HI)
    with torch.no_grad():
        got = t_pt.packed_encoder_front(_layer(p1), _layer(p2, stride=2),
                                        nchw(x))
    assert got.shape == (2, 48, 8, 8)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_packed_front_refuses_an_odd_size():
    """No quiet fallback: a shape the packed grid cannot hold raises."""
    net = MDGenerator()
    img, sk = torch.zeros(1, 3, 30, 31), torch.zeros(1, 1, 30, 31)
    with pytest.raises(ValueError, match="even"):
        net(img, sk, pack=True)


def _jax_to_port(wp, co, ci, packed_in, packed_out):
    """A JAX packed kernel (kh, kw, [4]ci, [4]co), phase-major channels, as
    the port's (([4]co, [4]ci, kh, kw)), channel-major channels."""
    kh, kw = wp.shape[:2]
    wp = wp.reshape(kh, kw, 4 if packed_in else 1, ci, 4 if packed_out
                    else 1, co)                        # (Y, X, Q, i, P, o)
    wp = wp.transpose(5, 4, 3, 2, 0, 1)                # (o, P, i, Q, Y, X)
    return wp.reshape(co * (4 if packed_out else 1),
                      ci * (4 if packed_in else 1), kh, kw)


@pytest.mark.parametrize("name,k,packed_in,packed_out", [
    ("deconv_packed_weights", 3, False, True),
    ("s2d_conv_weights", 3, True, True),
    ("s2d_conv_weights", 5, True, True),
    ("s2d_stride2_weights", 3, True, False),
    ("double_packed_deconv_weights", 3, True, True)])
def test_weight_maps_match_jax(name, k, packed_in, packed_out):
    ci, co = 5, 6
    w = np.random.RandomState(k).randn(k, k, ci, co).astype(np.float32)
    want = np.asarray(getattr(j_pt, name)(jnp.asarray(w)))
    got = getattr(t_pt, name)(torch.from_numpy(w.transpose(3, 2, 0, 1)))
    want = _jax_to_port(want, co, ci, packed_in, packed_out)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("tf32", [False, True])
def test_use_packing_env(monkeypatch, tf32):
    """The policy of the card's times: bfloat16 packs from B = 8 in eval
    mode only; float32 with TF32 allowed always; float32 with TF32 off
    below B = 8 in eval mode only. SKETCHEDIT_PACK and SKETCHEDIT_PACK_MID
    read on every call: unset or empty means the default, "0" off,
    anything else on; mid packing is off by default."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)
    cases = [(b, dt, tr) for b in (1, 4, 8, 64, 128)
             for dt in (torch.float32, torch.bfloat16) for tr in (False, True)]
    default = [t_pt.use_packing(*c) for c in cases]
    assert default == [
        (not tr and b >= t_pt.PACK_BFLOAT16_FROM) if dt == torch.bfloat16
        else tf32 or (not tr and b < t_pt.PACK_FLOAT32_BELOW)
        for b, dt, tr in cases]
    assert t_pt.PACK_FLOAT32_BELOW == t_pt.PACK_BFLOAT16_FROM == 8
    assert t_pt.use_packing(4) and t_pt.use_packing(8) == tf32
    assert t_pt.use_packing(4, training=True) == tf32
    assert any(default) and not all(default)
    monkeypatch.setenv("SKETCHEDIT_PACK", "")
    assert [t_pt.use_packing(*c) for c in cases] == default
    monkeypatch.setenv("SKETCHEDIT_PACK", "0")
    assert not any(t_pt.use_packing(*c) for c in cases)
    for on in ("1", "yes"):
        monkeypatch.setenv("SKETCHEDIT_PACK", on)
        assert all(t_pt.use_packing(*c) for c in cases)
    assert not t_pt.use_mid_packing()
    monkeypatch.setenv("SKETCHEDIT_PACK_MID", "")
    assert not t_pt.use_mid_packing()
    monkeypatch.setenv("SKETCHEDIT_PACK_MID", "1")
    assert t_pt.use_mid_packing()
    monkeypatch.setenv("SKETCHEDIT_PACK_MID", "0")
    assert not t_pt.use_mid_packing()


def test_nets_apply_the_policy_of_their_mode():
    """``pack=None``: a bfloat16 net at B = 8 packs in eval mode (serving)
    and not in training mode, as ``use_packing`` says."""
    assert t_pt.use_packing(8, torch.bfloat16)
    assert not t_pt.use_packing(8, torch.bfloat16, training=True)
    net = MDGenerator(dtype=torch.bfloat16)
    img = torch.zeros(8, 3, 16, 16, dtype=torch.bfloat16)
    sk = torch.zeros(8, 1, 16, 16, dtype=torch.bfloat16)
    with torch.no_grad():
        net(img, sk)
        assert not net.conv1.__dict__.get("_packed_cache")
        net.eval()(img, sk)
        assert net.conv1.__dict__.get("_packed_cache")


# --- the nets ----------------------------------------------------------

@pytest.fixture(scope="module")
def net_params():
    return {"M": scaled_params(j_m.init_params, 0, GAIN_M),
            "G": scaled_params(j_g.init_params, 1, GAIN_G)}


def _net(label, params):
    net = MDGenerator() if label == "M" else DeepFillC2Generator(
        DeepFillConfig())
    net.load_state_dict(jax_params_to_state_dict(params[label]), strict=True)
    return net.eval()


def _run_jax(label, params, B, pack):
    img, sketch, mask = (jnp.asarray(a) for a in _inputs(7, B=B))
    if label == "M":
        return j_m.apply(params["M"], img, sketch, precision=HI, pack=pack)
    return j_g.apply(params["G"], img, img, mask, mask, sketch,
                     config=j_g.DeepFillConfig(), precision=HI, pack=pack)


def _run_port(net, label, B, pack):
    img, sketch, mask = (nchw(a) for a in _inputs(7, B=B))
    with torch.no_grad():
        if label == "M":
            return net(img, sketch, pack=pack)
        return net(img, img, mask, mask, sketch, pack=pack)


@pytest.mark.parametrize("label", ["M", "G"])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("pack", [True, False])
def test_nets_match_jax_on_either_route(net_params, label, B, pack):
    """netM and netG with ``pack`` on against JAX's packed nets, off
    against JAX's plain ones, at 64^2."""
    want = _run_jax(label, net_params, B, pack)
    got = _run_port(_net(label, net_params), label, B, pack)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=1e-4)
        assert np.asarray(w).std() > 0.05         # not a vacuous compare


def test_netg_mid_packing_matches_jax(net_params, monkeypatch):
    """SKETCHEDIT_PACK_MID=1 (read by both packages): the five-layer tails
    through the double-packed deconv."""
    monkeypatch.setenv("SKETCHEDIT_PACK_MID", "1")
    want = _run_jax("G", net_params, 1, True)
    got = _run_port(_net("G", net_params), "G", 1, True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=1e-4)


@pytest.mark.parametrize("label", ["M", "G"])
def test_gradients_reach_the_weights_through_the_packed_layers(net_params,
                                                               label):
    """Under autograd the packed kernels are formed in the forward, so the
    OIHW weights get the plain route's gradients (relative L2 <= 1e-5 per
    tensor), also those of the packed layers."""
    img, sketch, mask = (nchw(a) for a in _inputs(3, B=1, H=32, W=32))
    grads = {}
    for pack in (True, False):
        net = _net(label, net_params)
        out = (net(img, sketch, pack=pack) if label == "M"
               else net(img, img, mask, mask, sketch, pack=pack))
        proj = torch.Generator().manual_seed(0)
        loss = sum((o * torch.randn(o.shape, generator=proj)).sum()
                   for o in out)
        loss.backward()
        grads[pack] = {n: p.grad.clone() for n, p in net.named_parameters()}
    packed_layers = ("conv1.", "conv17.", "conv_mask_16.", "allconv15",
                     "pmconv2_downsample.", "xconv1.")
    for n, want in grads[False].items():
        got = grads[True][n]
        if n.startswith(packed_layers):
            assert want.norm() > 0, n
        err = (got - want).norm() / max(want.norm(), 1e-30)
        assert err <= 1e-5, (n, err.item())


def test_state_dict_is_unchanged_by_packing(net_params):
    """The kept packed kernels stay outside the state dict: a net that ran
    packed has the keys and shapes of a fresh one, and its state dict
    loads strictly into a fresh net."""
    for label in ("M", "G"):
        fresh = _net(label, net_params).state_dict()
        net = _net(label, net_params)
        _run_port(net, label, 1, True)
        assert net.conv1.__dict__.get("_packed_cache")
        sd = net.state_dict()
        assert list(sd) == list(fresh)
        assert all(sd[k].shape == fresh[k].shape for k in sd)
        (MDGenerator() if label == "M" else DeepFillC2Generator()
         ).load_state_dict(sd, strict=True)


def test_kept_kernels_follow_load_and_optimizer_step(net_params):
    """Without autograd a packed kernel is formed once and reused; a
    ``load_state_dict`` or an optimizer step forms it again."""
    net = _net("M", net_params)
    _run_port(net, "M", 1, True)
    kept = dict(net.conv1._packed_cache)
    _run_port(net, "M", 1, True)
    assert all(net.conv1._packed_cache[k][1] is v[1] for k, v in kept.items())

    other = scaled_params(j_m.init_params, 5, GAIN_M)
    net.load_state_dict(jax_params_to_state_dict(other), strict=True)
    got = _run_port(net, "M", 1, True)
    want = _run_port(_net("M", {"M": other}), "M", 1, False)
    assert all(net.conv1._packed_cache[k][1] is not v[1]
               for k, v in kept.items())
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)

    img, sketch, _ = (nchw(a) for a in _inputs(4, B=1))
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    sum(o.sum() for o in net(img, sketch, pack=True)).backward()
    opt.step()
    stale = got
    got = _run_port(net, "M", 1, True)
    want = _run_port(net, "M", 1, False)
    for g, w, s in zip(got, want, stale):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)
        assert (g - s).abs().max() > 1e-3      # the step moved the outputs


def test_kept_kernels_follow_a_broadcast(net_params, monkeypatch):
    """A collective writes a tensor without moving its version counter, as
    a write through ``.data`` does; ``broadcast_`` (rank 0's train state
    to every rank) moves it, so the kept packed kernels are formed again
    from the weights that arrived. The collective is stood in for by a
    write through ``.data`` and a broadcast that leaves the values as they
    are (a one-rank group's)."""
    net = _net("M", net_params)
    _run_port(net, "M", 1, True)
    for p in net.parameters():
        p.data.mul_(0.9)
    want = _run_port(net, "M", 1, False)
    stale = _run_port(net, "M", 1, True)     # the old weights' kernels
    assert max((s - w).abs().max() for s, w in zip(stale, want)) > 1e-3
    monkeypatch.setattr(distributed.dist, "broadcast",
                        lambda tensor, src, group=None: None)
    distributed.broadcast_(list(net.parameters()))
    for g, w in zip(_run_port(net, "M", 1, True), want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-4)


def test_edit_u8_packed_by_the_policy_matches_jax(monkeypatch):
    """SKETCHEDIT_PACK=1 (read by both packages) puts the default policy's
    edit on the packed route: within 1 LSB of JAX's packed edit_u8."""
    monkeypatch.setenv("SKETCHEDIT_PACK", "1")
    seed = 4
    params = jax_params(seed)
    img, sketch = u8_inputs(seed, 64, 64)
    want_c, want_m = j_e.edit_u8(params, jnp.asarray(img),
                                 jnp.asarray(sketch))
    model = port_model(params)
    with torch.no_grad():
        got_c, got_m = t_e.edit_u8(model, torch.from_numpy(img),
                                   torch.from_numpy(sketch))
    assert model.netG.conv1._packed_cache    # the route taken was packed
    for g, w in ((got_c, want_c), (got_m, want_m)):
        diff = np.abs(g.numpy().astype(np.int16) - np.asarray(w).astype(
            np.int16))
        assert diff.max() <= 1, diff.max()


def test_packed_export(tmp_path, monkeypatch):
    """An artifact exported on the packed route (SKETCHEDIT_PACK=1) records
    it in its metadata and sidecar, holds the packed kernels as constants
    (the program reads no packed layer's own weight), equals the live
    packed edit bit for bit and lies within 1 LSB of the live plain
    edit."""
    seed, size = 9, 32
    model = port_model(jax_params(seed))
    img, sk = u8_inputs(seed, size, size, B=1)
    path = str(tmp_path / "edit_packed.pt2")
    monkeypatch.setenv("SKETCHEDIT_PACK", "1")
    meta = export_edit_artifact(model, path, size=size, batch=1)
    call = load_edit_artifact(path)
    assert meta["pack"] is True and call.meta["pack"] is True
    assert json.load(open(path + ".json"))["pack"] is True
    nodes = list(torch.export.load(path).graph.nodes)
    assert "aten.pixel_unshuffle.default" in {str(n.target) for n in nodes}
    fronts = [n for n in nodes
              if n.op == "placeholder" and n.name.endswith("conv1_weight")]
    assert len(fronts) == 5 and not any(n.users for n in fronts)
    got = call(img, sk)
    live = {}
    for p in (True, False):
        monkeypatch.setenv("SKETCHEDIT_PACK", str(int(p)))
        with torch.no_grad():
            live[p] = t_e.edit_u8(model, torch.from_numpy(img),
                                  torch.from_numpy(sk))
    for g, packed, plain in zip(got, live[True], live[False]):
        torch.testing.assert_close(g, packed, rtol=0, atol=0)
        assert (g.int() - plain.int()).abs().max() <= 1
