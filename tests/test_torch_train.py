"""The port's training stack against the JAX package's on the CPU: losses,
the discriminator, generate_fake_train, and one G+D step per branch flag
against JAX's ``train_step`` with the same params, batch and flags.

The JAX reference runs at Precision.HIGHEST with its dense attention; the
port runs through ``attention_impl="kernel"`` (on the CPU its plain version,
inside the autograd Function and its fold). Images are 32^2 with B = 2,
except in bfloat16, which runs at 64^2: PyTorch's CPU bf16 convolution
returns non-finite weight gradients for the discriminator's last layer when
its input is 1 x 1 (dconv6 at 32^2).

Tolerances, float32 on both sides through ~80 convs: losses rtol 1e-4;
gradients 2e-3 of each tensor's max |value| (an absolute floor, so near-zero
entries of a tensor do not fail on relative noise). Updated params: Adam's
first step moves each weight by lr * g / (|g| + 1e-8), i.e. by ±lr with the
sign of g. Where |g| exceeds the gradient tolerance, both sides agree on the
sign and the updates within 5% of lr; where |g| is below it the sign is
noise and the two updates may differ by up to 2 lr.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from sketchedit_tpu.models import deepfill_c2 as j_g
from sketchedit_tpu.models import discriminator as j_d
from sketchedit_tpu.models import md_generator as j_m
from sketchedit_tpu.train import losses as j_losses
from sketchedit_tpu.train import trainer as j_tr
from sketchedit_tpu_torch.models import deepfill_c2, discriminator, md_generator
from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
from sketchedit_tpu_torch.params.convert import (
    jax_params_to_state_dict, state_dict_to_jax_params)
from sketchedit_tpu_torch.train import losses
from sketchedit_tpu_torch.train import trainer as tr

GAIN_M, GAIN_G = 1.7, 1.5
GRAD_REL = 2e-3
# PRNGKey(i) -> (G flag, D flag) under JAX's train_step split
KEYS = {1: (0, 2), 3: (1, 1), 7: (2, 0)}


def _tiny_batch(B=2, H=32, seed=0):
    rs = np.random.RandomState(seed)
    return {
        "image": rs.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
        "gt": rs.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
        "mask": (rs.rand(B, H, H, 1) > 0.9).astype(np.float32),
        "edgegt": (rs.rand(B, H, H, 1) > 0.9).astype(np.float32),
        "random_mask": (rs.rand(B, H, H, 1) > 0.7).astype(np.float32),
        "random_mask2": (rs.rand(B, H, H, 1) > 0.7).astype(np.float32),
    }


def _port_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _port_state(cfg, seed=0):
    """Fresh port state with netM / netG weights scaled so that the outputs
    are not flat (kaiming alone leaves them within 1e-3 of the midpoint)."""
    state = tr.init_train_state(cfg, seed=seed)
    with torch.no_grad():
        for label, gain in (("M", GAIN_M), ("G", GAIN_G)):
            for conv in state.nets[label].children():
                conv.weight.mul_(gain)
    return state


def _jax_params(state):
    return jax.tree_util.tree_map(jnp.asarray, {
        label: state_dict_to_jax_params(net.state_dict())
        for label, net in state.nets.items()})


def _jax_state(params, cfg):
    opt_g, opt_d = j_tr.make_optimizers(cfg)
    return {"params": params,
            "opt_g": opt_g.init({"M": params["M"], "G": params["G"]}),
            "opt_d": opt_d.init(j_d.trainable(params["D"])),
            "step": jnp.zeros((), jnp.int32)}


def _close_rel(got, want, rel, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


def _grads_by_layer(pairs, net_labels, nets):
    """[(param, grad)] over the given nets -> {label: {layer: {w, b}}} in
    the JAX layout."""
    grads = iter(g for _, g in pairs)
    out = {}
    for label in net_labels:
        sd = {}
        for name, p in nets[label].named_parameters():
            g = next(grads)
            sd[name] = torch.zeros_like(p) if g is None else g
        out[label] = state_dict_to_jax_params(sd)
    return out


@pytest.fixture(scope="module")
def parity():
    """One port state and batch; the JAX step and gradients for each key of
    KEYS, from one compile each (the flag is traced)."""
    cfg = tr.TrainConfig(netg=DeepFillConfig(attention_impl="kernel"))
    jcfg = j_tr.TrainConfig(precision="highest")
    state = _port_state(cfg)
    params = _jax_params(state)
    batch = _tiny_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def grads(params, batch, flag):
        gen_params = {"M": params["M"], "G": params["G"]}

        def g_total(gp):
            gen = j_tr.generate_fake_train(gp, batch, flag, jcfg)
            G = j_tr.g_image_loss(params["D"], gen, batch, jcfg)
            return sum(G.values()), (G, gen)

        (_, (G, gen)), gg = jax.value_and_grad(g_total, has_aux=True)(
            gen_params)

        def d_total(dt):
            return j_tr.d_loss_fn(j_d.with_u(dt, params["D"]), gen_params,
                                  batch, flag, jcfg)

        (d_sum, (d_fake, d_real, new_d)), dg = jax.value_and_grad(
            d_total, has_aux=True)(j_d.trainable(params["D"]))
        return G, gen, gg, (d_sum, d_fake, d_real), dg, new_d

    jgrads = jax.jit(grads)
    jstep = jax.jit(lambda st, b, k: j_tr.train_step(st, b, k, jcfg))
    flags = sorted({f for fs in KEYS.values() for f in fs})
    ref_grads = {f: jax.device_get(jgrads(params, jbatch, jnp.int32(f)))
                 for f in flags}
    ref_steps = {}
    for k in KEYS:
        new_state, metrics = jstep(_jax_state(params, jcfg), jbatch,
                                   jax.random.PRNGKey(k))
        ref_steps[k] = jax.device_get((new_state["params"], metrics))
    return dict(cfg=cfg, state=state, batch=batch, params=params,
                grads=ref_grads, steps=ref_steps)


def test_keys_give_the_flags():
    for k, (fg, fd) in KEYS.items():
        kg, kd = jax.random.split(jax.random.PRNGKey(k))
        assert (int(jax.random.randint(kg, (), 0, 3)),
                int(jax.random.randint(kd, (), 0, 3))) == (fg, fd)


@pytest.mark.parametrize("flag", [0, 1, 2])
def test_generate_fake_train_matches_jax(parity, flag):
    cfg, state = parity["cfg"], parity["state"]
    batch = tr.decompress_batch(_port_batch(parity["batch"]))
    with torch.no_grad():
        gen = tr.generate_fake_train(state.nets["M"], state.nets["G"], batch,
                                     flag, cfg)
    want = parity["grads"][flag][1]
    for k, v in want.items():
        np.testing.assert_allclose(_nhwc(gen[k]), v, rtol=0, atol=1e-4,
                                   err_msg=k)
    assert np.asarray(want["fake"]).std() > 0.05      # not a flat compare
    if flag == 0:
        np.testing.assert_array_equal(_nhwc(gen["mask_inpaint"]),
                                      parity["batch"]["random_mask"])
    if flag == 2:
        assert set(np.unique(_nhwc(gen["mask_inpaint"]))) <= {0.0, 1.0}


@pytest.mark.parametrize("flag", [0, 1, 2])
def test_g_and_d_gradients_match_jax(parity, flag):
    """Generator losses and gradients (netM and netG), and the
    discriminator's loss and gradients with fakes regenerated by the same
    (initial) generator, per branch flag."""
    cfg = parity["cfg"]
    state = copy.deepcopy(parity["state"])
    batch = tr.decompress_batch(_port_batch(parity["batch"]))
    G_j, _, gg_j, d_j, dg_j, new_d = parity["grads"][flag]

    _, G, g_pairs, _ = tr.g_step_grads(state, batch, flag, cfg)
    assert set(G) == set(G_j)
    for k in G:
        np.testing.assert_allclose(G[k].item(), float(G_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    got = _grads_by_layer(g_pairs, ("M", "G"), state.nets)
    for label in ("M", "G"):
        for layer, leaves in gg_j[label].items():
            for leaf in ("w", "b"):
                _close_rel(got[label][layer][leaf], leaves[leaf], GRAD_REL,
                           f"{label}.{layer}.{leaf}")
    assert np.abs(gg_j["G"]["pmconv1"]["w"]).max() > 0

    d_sum, d_fake, d_real, d_pairs, new_u = tr.d_step_grads(
        state, batch, flag, cfg)
    for g, w in zip((d_sum, d_fake, d_real), d_j):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4)
    got_d = _grads_by_layer(d_pairs, ("D",), state.nets)["D"]
    for layer, leaves in dg_j.items():
        for leaf in ("w", "b"):
            _close_rel(got_d[layer][leaf], leaves[leaf], GRAD_REL,
                       f"D.{layer}.{leaf}")
        np.testing.assert_allclose(new_u[layer].numpy(), new_d[layer]["u"],
                                   rtol=1e-5, atol=1e-6)


def _assert_adam_step_matches(p0, p_port, p_jax, grad_ref, lr, name):
    d_port, d_jax = p_port - p0, p_jax - p0
    diff = np.abs(d_port - d_jax)
    noise = np.abs(grad_ref) <= GRAD_REL * np.abs(grad_ref).max()
    assert diff.max() <= 2 * lr * (1 + 1e-4), name
    assert (diff[~noise] <= 0.05 * lr).all(), name
    assert np.abs(d_jax).max() > 0.5 * lr, name          # the weight moved


@pytest.mark.parametrize("key", sorted(KEYS))
def test_train_step_matches_jax(parity, key):
    """One G+D step in place against JAX's train_step with the flags its
    key draws: metrics, and netM / netG / netD after the update."""
    cfg = parity["cfg"]
    flag_g, flag_d = KEYS[key]
    state = copy.deepcopy(parity["state"])
    before = {label: state_dict_to_jax_params(net.state_dict())
              for label, net in state.nets.items()}
    state, metrics = tr.train_step(state, _port_batch(parity["batch"]),
                                   flag_g, flag_d, cfg)
    new_params, metrics_j = parity["steps"][key]
    assert state.step == 1 and float(metrics["flag"]) == flag_g
    assert set(metrics) == set(metrics_j)
    for k in metrics:
        # D_Fake / D_real read fakes from the updated generator, whose
        # noise-level weights may differ by 2 lr (see the module docstring)
        rtol = 1e-3 if k.startswith("D_") else 1e-4
        np.testing.assert_allclose(float(metrics[k]), float(metrics_j[k]),
                                   rtol=rtol, atol=1e-6, err_msg=k)
    after = {label: state_dict_to_jax_params(net.state_dict())
             for label, net in state.nets.items()}
    gg = parity["grads"][flag_g][2]
    for label in ("M", "G"):
        for layer in gg[label]:
            for leaf in ("w", "b"):
                _assert_adam_step_matches(
                    before[label][layer][leaf], after[label][layer][leaf],
                    new_params[label][layer][leaf], gg[label][layer][leaf],
                    cfg.g_lr(), f"{label}.{layer}.{leaf}")
    # D's gradients come from fakes of the updated generator on each side,
    # so they are not the fixture's; hold the step to ±lr and to the JAX
    # step on all but a sliver of noise-level entries
    flips = total = 0
    for layer, leaves in new_params["D"].items():
        for leaf in ("w", "b"):
            d = np.abs((after["D"][layer][leaf] - before["D"][layer][leaf])
                       - (leaves[leaf] - before["D"][layer][leaf]))
            assert d.max() <= 2 * cfg.d_lr() * (1 + 1e-4), layer
            flips += int((d > 0.05 * cfg.d_lr()).sum())
            total += d.size
        np.testing.assert_allclose(after["D"][layer]["u"], leaves["u"],
                                   rtol=1e-4, atol=1e-5, err_msg=layer)
    assert flips <= 0.005 * total, (flips, total)


def test_kernel_path_step_equals_dense_step(parity):
    """On the CPU the kernel path (the autograd Function with the plain
    versions) and the dense path give the same losses and gradients."""
    batch = tr.decompress_batch(_port_batch(parity["batch"]))
    results = {}
    for impl in ("dense", "kernel"):
        cfg = tr.TrainConfig(netg=DeepFillConfig(attention_impl=impl))
        state = copy.deepcopy(parity["state"])
        state.nets["G"].config = cfg.netg
        _, G, pairs, _ = tr.g_step_grads(state, batch, 1, cfg)
        results[impl] = (G, [g for _, g in pairs])
    (G_d, g_d), (G_k, g_k) = results["dense"], results["kernel"]
    for k in G_d:
        np.testing.assert_allclose(float(G_k[k]), float(G_d[k]), rtol=1e-5)
    for a, b in zip(g_k, g_d):
        _close_rel(a.numpy(), b.numpy(), 1e-4)


def test_gan_loss_modes_and_bce_match_jax():
    rs = np.random.RandomState(0)
    pred = rs.randn(2, 1, 3, 3).astype(np.float32) * 2
    tp = torch.from_numpy(pred)
    jp = jnp.asarray(pred.transpose(0, 2, 3, 1))
    for mode in ("hinge", "ls", "original", "w"):
        for real in (True, False):
            for for_d in (True, False):
                if mode == "hinge" and not for_d and not real:
                    continue
                kw = dict(mode=mode, for_discriminator=for_d)
                np.testing.assert_allclose(
                    float(losses.gan_loss(tp, real, **kw)),
                    float(j_losses.gan_loss(jp, real, **kw)), rtol=1e-6,
                    err_msg=f"{mode} {real} {for_d}")
    # the list branch (multiscale D) averages the per-scale losses
    np.testing.assert_allclose(
        float(losses.gan_loss([tp, tp[:, :, :2, :2]], True)),
        float(j_losses.gan_loss([jp, jp[:, :2, :2]], True)), rtol=1e-6)
    with pytest.raises(ValueError):
        losses.gan_loss(tp, False, mode="hinge", for_discriminator=False)
    m = 1 / (1 + np.exp(-rs.randn(2, 1, 8, 8) * 8)).astype(np.float32)
    m[0, 0, 0, 0] = 1.0                     # saturated: the floor applies
    t = (rs.rand(2, 1, 8, 8) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.mask_bce_loss(torch.from_numpy(m), torch.from_numpy(t))),
        float(j_losses.mask_bce_loss(jnp.asarray(m), jnp.asarray(t))),
        rtol=1e-5)


@pytest.mark.parametrize("imagenet_norm", [True, False])
def test_vgg_loss_matches_jax_with_random_weights(imagenet_norm):
    rs = np.random.RandomState(1)
    arrays, cin = [], 3
    for c in j_losses._VGG_CFG:
        if c == "M":
            continue
        arrays.append(((rs.randn(3, 3, cin, c) * np.sqrt(2.0 / (9 * cin))
                        ).astype(np.float32),
                       (rs.randn(c) * 0.01).astype(np.float32)))
        cin = c
    x = rs.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    y = rs.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    want = j_losses.vgg_loss([{"w": jnp.asarray(w), "b": jnp.asarray(b)}
                              for w, b in arrays],
                             jnp.asarray(x), jnp.asarray(y), imagenet_norm)
    params = losses.vgg_params_from_arrays(arrays)
    got = losses.vgg_loss(params, torch.from_numpy(x.transpose(0, 3, 1, 2)),
                          torch.from_numpy(y.transpose(0, 3, 1, 2)),
                          imagenet_norm)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
    assert float(want) > 0


def test_load_vgg_params(tmp_path, monkeypatch):
    monkeypatch.delenv("SKETCHEDIT_VGG_WEIGHTS", raising=False)
    assert losses.load_vgg_params() is None
    path = tmp_path / "vgg.npz"
    np.savez(path, conv_0_w=np.zeros((3, 3, 3, 64), np.float32),
             conv_0_b=np.zeros(64, np.float32))
    with pytest.raises(ValueError, match="VGG19 needs 16"):
        losses.load_vgg_params(str(path))


@pytest.mark.parametrize("multiscale", [False, True])
def test_discriminator_logits_and_u_update_match_jax(multiscale):
    """Logits and the power-iteration vectors after one update, on params
    from the JAX init (xavier, u ~ N(0, 1)) carried across the converter."""
    key = jax.random.PRNGKey(5)
    params = (j_d.init_multiscale_params(key, num_d=2) if multiscale
              else j_d.init_params(key))
    net = (discriminator.MultiscaleDiscriminator(2) if multiscale
           else discriminator.Discriminator())
    net.load_state_dict(jax_params_to_state_dict(jax.device_get(params)),
                        strict=True)
    rs = np.random.RandomState(2)
    img = rs.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    line = (rs.rand(2, 64, 64, 1) > 0.8).astype(np.float32)
    want, new_params = j_d.apply(params, *map(jnp.asarray, (img, line, img)),
                                 update_sn=True,
                                 precision=jax.lax.Precision.HIGHEST)
    t = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
         for a in (img, line, img)]
    got, new_u = net(*t, update_sn=True)
    assert torch.equal(net(*t)[0] if multiscale else net(*t), got[0]
                       if multiscale else got)
    if not multiscale:
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=1e-4,
                                   atol=1e-6 * np.abs(np.asarray(w)).max())
    flat = state_dict_to_jax_params(
        {f"{k}.u": v for k, v in new_u.items()})
    want_u = jax.device_get(new_params)
    for path, u in jax.tree_util.tree_flatten_with_path(flat)[0]:
        keys = [p.key for p in path]
        node = want_u
        for k in keys:
            node = node[k]
        np.testing.assert_allclose(u, node, rtol=1e-5, atol=1e-6)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    discriminator.load_u_(net, new_u)
    moved = [k for k, v in net.state_dict().items()
             if not torch.equal(v, before[k])]
    assert moved and all(k.endswith(".u") for k in moved)


def test_downsample2_matches_jax():
    rs = np.random.RandomState(0)
    for h, w in ((8, 8), (9, 7), (5, 5)):
        x = rs.randn(2, h, w, 3).astype(np.float32)
        want = np.asarray(j_d._downsample2(jnp.asarray(x)))
        got = discriminator._downsample2(
            torch.from_numpy(x.transpose(0, 3, 1, 2)))
        np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)


def test_param_groups_match_jax():
    for stage in ("all", "image", "mask", "maskim", "coarse", "fine", "none"):
        for j_mod, t_mod in ((j_m, md_generator), (j_g, deepfill_c2)):
            names = [n for n, *_ in j_mod.LAYER_SPECS]
            assert (sorted(t_mod.param_groups(names, stage))
                    == sorted(j_mod.param_groups({n: 0 for n in names},
                                                 stage))), stage
    assert tr.TrainConfig(update_part="mask").train_mask_only
    assert not tr.TrainConfig(update_part="fine").train_mask_only


def test_update_part_mask_freezes_netg():
    cfg = tr.TrainConfig(update_part="mask", no_gan_loss=True)
    state = tr.init_train_state(cfg)
    g0 = copy.deepcopy(state.nets["G"].state_dict())
    m0 = state.nets["M"].conv1.weight.clone()
    d0 = copy.deepcopy(state.nets["D"].state_dict())
    tr.train_step(state, _port_batch(_tiny_batch()), 1, 1, cfg)
    for k, v in state.nets["G"].state_dict().items():
        assert torch.equal(v, g0[k]), k
    for k, v in state.nets["D"].state_dict().items():   # no_gan_loss
        assert torch.equal(v, d0[k]), k
    assert not torch.equal(state.nets["M"].conv1.weight, m0)


def test_reuse_fake_and_multiscale_steps_update_every_net():
    batch = _port_batch(_tiny_batch())
    for cfg in (tr.TrainConfig(reuse_fake=True),
                tr.TrainConfig(netd="multiscale", num_d=2)):
        state = tr.init_train_state(cfg)
        before = {lab: copy.deepcopy(net.state_dict())
                  for lab, net in state.nets.items()}
        _, metrics = tr.train_step(state, batch, 0, 2, cfg)
        assert all(np.isfinite(float(v)) for v in metrics.values())
        for lab, net in state.nets.items():
            sd = net.state_dict()
            moved = [k for k in sd if k.endswith("dconv1.weight")
                     or k == "conv1.weight"]
            assert moved, lab
            for k in moved:
                assert not torch.equal(sd[k], before[lab][k]), (lab, k)


def test_remat_step_matches_plain():
    batch = _port_batch(_tiny_batch())
    out = []
    for remat in (False, True):
        cfg = tr.TrainConfig(remat=remat)
        state = tr.init_train_state(cfg)
        state, metrics = tr.train_step(state, batch, 1, 2, cfg)
        out.append((state, metrics))
    (s0, m0), (s1, m1) = out
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6)
    for lab in ("M", "G", "D"):
        for (k, a), b in zip(s0.nets[lab].state_dict().items(),
                             s1.nets[lab].state_dict().values()):
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7, msg=k)


def test_bf16_losses_track_f32():
    """compute_dtype bfloat16: parameters stay float32, the step updates
    them, and the losses agree loosely with float32 (64^2, see the module
    docstring)."""
    batch = _port_batch(_tiny_batch(H=64, seed=3))
    results = {}
    for dt in ("float32", "bfloat16"):
        cfg = tr.TrainConfig(compute_dtype=dt)
        state = tr.init_train_state(cfg)
        w0 = state.nets["G"].conv1.weight.clone()
        state, metrics = tr.train_step(state, batch, 1, 2, cfg)
        w1 = state.nets["G"].conv1.weight
        assert w1.dtype == torch.float32 and not torch.equal(w0, w1)
        for lab, net in state.nets.items():
            for k, v in net.state_dict().items():
                assert torch.isfinite(v).all(), (dt, lab, k)
        results[dt] = {k: float(v) for k, v in metrics.items()}
    a, b = results["float32"], results["bfloat16"]
    np.testing.assert_allclose(b["G_total"], a["G_total"], rtol=0.05)
    np.testing.assert_allclose(b["L1c"], a["L1c"], rtol=0.05)


def test_lr_schedule_matches_optax():
    cfg = tr.TrainConfig(lr=0.1, no_TTUR=True, lr_decay_start=2,
                         lr_decay_steps=4)
    jcfg = j_tr.TrainConfig(lr=0.1, no_TTUR=True, lr_decay_start=2,
                            lr_decay_steps=4)
    sched = jcfg.lr_schedule(0.1)
    for step in range(9):
        assert cfg.lr_at(0.1, step) == pytest.approx(float(sched(step)),
                                                     rel=1e-6, abs=1e-9)
    assert tr.TrainConfig(lr=0.1).lr_at(0.05, 10 ** 6) == 0.05
    # Adam with a constant gradient steps by the scheduled lr; torch and
    # optax round the bias corrections differently (1e-5 relative)
    cfg = tr.TrainConfig(lr=0.1, no_TTUR=True, beta1=0.9, beta2=0.999,
                         lr_decay_start=2, lr_decay_steps=4)
    w = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([w], lr=0.1, betas=(0.9, 0.999), eps=1e-8)
    jopt = optax.adam(jcfg.lr_schedule(0.1), b1=0.9, b2=0.999)
    jstate = jopt.init({"w": jnp.ones(3)})
    for step in range(6):
        before = w.detach().clone()
        w.grad = torch.ones(3)
        tr._step_optimizer(opt, 0.1, step, cfg)
        upd, jstate = jopt.update({"w": jnp.ones(3)}, jstate)
        np.testing.assert_allclose((w.detach() - before).numpy(),
                                   np.asarray(upd["w"]), rtol=1e-4)


def test_draw_flags_range_and_resume():
    cfg = tr.TrainConfig()
    state = tr.init_train_state(cfg, flag_seed=3)
    draws = [tr.draw_flags(state, cfg) for _ in range(50)]
    assert {f for pair in draws for f in pair} == {0, 1, 2}
    no_joint = tr.TrainConfig(netg=DeepFillConfig(joint_train_inp=False))
    assert all(1 <= f <= 2 for _ in range(30)
               for f in tr.draw_flags(state, no_joint))
