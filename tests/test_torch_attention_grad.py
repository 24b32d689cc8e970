"""Gradients of the port's contextual attention against the JAX package on
the CPU: the backward plain version and the joint backward op's plain
version against ``_attention_core_bwd_pallas`` (the flash dQ / dK / dV
kernels, in interpret mode, as tests/test_attention_grad.py runs them),
the routes of ``attention_core_bwd``, ``ContextualAttentionCore`` (the
autograd Function around the kernels) against ``jax.grad`` through
``attention_core_pallas``, and the fused contextual attention inside netG.

Tolerances: rtol = atol = 2e-4 where both sides run the same flash
algorithm in float32 (the JAX attention tests' tolerance); 2e-4 of each
tensor's max |value| for the Function's gradients, whose fold sums three
terms; bf16 inputs are held to the float32 gradients on the same rounded
values at rtol 0.05 and 0.02 of the max, the JAX package's own bf16 rule.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sketchedit_tpu.models import deepfill_c2 as j_g
from sketchedit_tpu.ops.attention_pallas import (
    _attention_core_bwd_pallas, _attention_core_raw, attention_core_pallas,
    attention_core_pallas_shared, contextual_attention_pallas)
from sketchedit_tpu_torch.models.deepfill_c2 import (
    DeepFillC2Generator, DeepFillConfig)
from sketchedit_tpu_torch.ops import attention_cuda
from sketchedit_tpu_torch.ops.attention_cuda import (
    attention_core_bwd, attention_core_bwd_joint,
    attention_core_bwd_joint_reference, attention_core_bwd_reference,
    attention_core_differentiable, attention_core_dk,
    attention_core_dk_reference, attention_core_dv,
    attention_core_dv_reference, contextual_attention_fused)
from sketchedit_tpu_torch.params.convert import jax_params_to_state_dict

TOL = dict(rtol=2e-4, atol=2e-4)


def _close_rel(got, want, rel, name=""):
    """|got - want| <= rel * max|want| elementwise (max |want| > 0)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert scale > 0, name
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


def _core_inputs(seed, B, N, P, D, keep_p):
    rs = np.random.RandomState(seed)
    Q = (rs.randn(B, N, D) * D ** -0.5).astype(np.float32)
    K = rs.randn(B, P, D).astype(np.float32)
    V = rs.randn(B, P, D).astype(np.float32)
    keep = (rs.rand(B, P) < keep_p).astype(np.float32)
    keep[0, :7] = 0.0
    dO = rs.randn(B, N, D).astype(np.float32)
    kscale = (0.5 + rs.rand(B, D)).astype(np.float32)
    return Q, K, V, keep, dO, kscale


@pytest.mark.parametrize("keep_p", [0.7, 0.0], ids=["gated", "all_gated"])
def test_bwd_reference_matches_pallas_kernels(keep_p):
    """Unaligned N, P and D (2 x 130 x 150 x 70): the backward plain version
    fed the Pallas forward's float32 output and logsumexp gives the Pallas
    dQ / dK / dV."""
    Q, K, V, keep, dO, _ = _core_inputs(0, 2, 130, 150, 70, keep_p)
    jq, jk, jv, jkeep, jdo = map(jnp.asarray, (Q, K, V, keep, dO))
    with pltpu.force_tpu_interpret_mode():
        out, lse = _attention_core_raw(jq, jk, jv, jkeep, return_lse=True,
                                       out_dtype=jnp.float32)
        want = _attention_core_bwd_pallas(jq, jk, jv, jkeep, out, lse, jdo,
                                          10.0)
    t = torch.from_numpy
    got = attention_core_bwd_reference(
        t(Q), t(K), t(V), t(keep), t(np.array(out)), t(np.array(lse)),
        t(dO), 10.0)
    for name, g, w in zip(("dQ", "dK", "dV"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    if keep_p == 0.0:       # all-gated: S is multiplied by 0, so no dQ / dK
        assert not got[0].any() and not got[1].any()


@pytest.mark.parametrize("with_kscale", [False, True],
                         ids=["keys", "kscale"])
@pytest.mark.parametrize("keep_p", [0.7, 0.0], ids=["gated", "all_gated"])
def test_bwd_joint_op_reference_matches_pallas_kernels(keep_p, with_kscale):
    """The joint backward op (``sketchedit::attention_bwd``) on CPU tensors,
    its plain version (P and dS formed once for dQ, dK and dV), at
    unaligned 2 x 130 x 150 x 70 with the Pallas forward's float32 output
    and logsumexp, against the Pallas dQ / dK / dV; with kscale the JAX
    side takes the keys K kscale, so dK_eff is the gradient of those."""
    Q, K, V, keep, dO, ks = _core_inputs(3, 2, 130, 150, 70, keep_p)
    keys = K * ks[:, None, :] if with_kscale else K
    jq, jk, jv, jkeep, jdo = map(jnp.asarray, (Q, keys, V, keep, dO))
    with pltpu.force_tpu_interpret_mode():
        out, lse = _attention_core_raw(jq, jk, jv, jkeep, return_lse=True,
                                       out_dtype=jnp.float32)
        want = _attention_core_bwd_pallas(jq, jk, jv, jkeep, out, lse, jdo,
                                          10.0)
    t = torch.from_numpy
    out_t, lse_t = t(np.array(out)), t(np.array(lse))
    before = attention_cuda.LAUNCHES_BWD
    got = attention_cuda._bwd_op(
        t(Q), t(K), t(V), t(keep), lse_t, (t(dO) * out_t).sum(-1), t(dO),
        10.0, t(ks) if with_kscale else None)
    assert attention_cuda.LAUNCHES_BWD == before
    for name, g, w in zip(("dQ", "dK", "dV"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    if keep_p == 0.0:       # all-gated: S is multiplied by 0, so no dQ / dK
        assert not got[0].any() and not got[1].any()


def test_bwd_wrapper_takes_plain_version_on_cpu():
    Q, K, V, keep, dO, ks = map(torch.from_numpy,
                                _core_inputs(1, 1, 20, 24, 8, 0.5))
    out, lse = attention_cuda.attention_core(Q, K, V, keep, return_lse=True,
                                             kscale=ks)
    counters = ("LAUNCHES_DQ", "LAUNCHES_DKDV", "LAUNCHES_BWD", "LAUNCHES_DV",
                "LAUNCHES_DK")
    before = [getattr(attention_cuda, c) for c in counters]
    got = attention_core_bwd(Q, K, V, keep, out, lse, dO, 10.0, ks)
    assert [getattr(attention_cuda, c) for c in counters] == before
    want = attention_core_bwd_reference(Q, K, V, keep, out, lse, dO, 10.0, ks)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError):
        attention_core_bwd(Q, K, V, keep, out, lse[:, :-1], dO, 10.0, ks)


def _jax_grads_with_kscale(Q, K, V, keep, cot, ks):
    def loss(q, k, v, s):
        out = attention_core_pallas(q, k * s[:, None, :], v, keep)
        return jnp.sum(out * cot)
    with pltpu.force_tpu_interpret_mode():
        return jax.grad(loss, argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, (Q, K, V, ks)))


def test_function_gradients_match_jax():
    """dQ, dK, dV and dkscale through ContextualAttentionCore (the kernel
    path's autograd) against jax.grad through the Pallas custom VJP with
    the keys scaled outside."""
    Q, K, V, keep, cot, ks = _core_inputs(2, 2, 130, 150, 70, 0.7)
    want = _jax_grads_with_kscale(Q, K, V, jnp.asarray(keep), jnp.asarray(cot),
                                  ks)
    tq, tk, tv, tks = (torch.from_numpy(a).requires_grad_()
                       for a in (Q, K, V, ks))
    out = attention_core_differentiable(tq, tk, tv, torch.from_numpy(keep),
                                        kscale=tks)
    assert out.grad_fn is not None and out.dtype == torch.float32
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                              (tq, tk, tv, tks))
    for name, g, w in zip(("Q", "K", "V", "kscale"), got, want):
        _close_rel(g.numpy(), w, 2e-4, name)


def test_function_shared_tensor_matches_jax_shared_vjp():
    """Q, K and V one tensor (the main path): the Function returns the sum
    of the three gradients once; against the JAX shared-tensor VJP."""
    rs = np.random.RandomState(11)
    B, N, D = 2, 170, 70
    V = rs.randn(B, N, D).astype(np.float32) * 0.3
    ks = (0.5 + rs.rand(B, D)).astype(np.float32)
    keep = (rs.rand(B, N) > 0.4).astype(np.float32)
    keep[1, :] = 0.0
    cot = rs.randn(B, N, D).astype(np.float32)

    def loss(v, s):
        return jnp.sum(attention_core_pallas_shared(v, s, jnp.asarray(keep))
                       * cot)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(V), jnp.asarray(ks))
    tv, tks = (torch.from_numpy(a).requires_grad_() for a in (V, ks))
    out = attention_core_differentiable(tv, tv, tv, torch.from_numpy(keep),
                                        kscale=tks)
    got = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), (tv, tks))
    for name, g, w in zip(("V", "kscale"), got, want):
        _close_rel(g.numpy(), w, 2e-4, name)


@pytest.mark.parametrize("H", [16, 24])
def test_fused_contextual_attention_gradient_matches_jax(H):
    rs = np.random.RandomState(H)
    C = 12
    f = np.maximum(rs.randn(2, H, H, C), 0).astype(np.float32)
    mask = (rs.rand(2, H, H, 1) > 0.5).astype(np.float32)
    mask[1, : H // 2] = 1.0
    cot = rs.randn(2, H, H, C).astype(np.float32)

    def loss(x):
        return jnp.sum(contextual_attention_pallas(x, x, jnp.asarray(mask))
                       * cot)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss)(jnp.asarray(f))
    ft = torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2))
                          ).requires_grad_()
    mt = torch.from_numpy(np.ascontiguousarray(mask.transpose(0, 3, 1, 2)))
    out = contextual_attention_fused(ft, ft, mt)
    cot_t = torch.from_numpy(np.ascontiguousarray(cot.transpose(0, 3, 1, 2)))
    got, = torch.autograd.grad((out * cot_t).sum(), ft)
    _close_rel(got.numpy().transpose(0, 2, 3, 1), want, 2e-4)


def test_bf16_gradients_track_f32():
    """bfloat16 Q, K, V through the Function: the float32 gradients of the
    dense formula on the same rounded values, within bf16 rounding."""
    Q, K, V, keep, cot, ks = _core_inputs(7, 2, 128, 128, 64, 0.7)
    keep_t, cot_t, ks_t = map(torch.from_numpy, (keep, cot, ks))
    bf = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (Q, K, V)]
    out = attention_core_differentiable(*bf, keep_t, kscale=ks_t)
    got = torch.autograd.grad((out * cot_t).sum(), bf)
    f32 = [t.detach().float().requires_grad_() for t in bf]
    logits = torch.bmm(f32[0], (f32[1] * ks_t[:, None, :]).transpose(1, 2))
    w = torch.softmax(logits * keep_t[:, None, :] * 10.0, dim=-1)
    want = torch.autograd.grad((torch.bmm(w, f32[2]) * cot_t).sum(), f32)
    for name, g, w_ in zip("QKV", got, want):
        assert g.dtype == torch.bfloat16
        scale = w_.abs().max().item()
        torch.testing.assert_close(g.float(), w_, rtol=0.05,
                                   atol=0.02 * scale, msg=name)


def test_netg_gradients_reach_pmconv_through_the_kernel_path():
    """The repaired fault: through attention_impl='kernel' the gradient
    reaches pmconv1...pmconv6 (the layers before the attention) and equals
    the dense path's. Before the Function, the kernel's output carried no
    grad_fn and these gradients were silently cut."""
    params = j_g.init_params(jax.random.PRNGKey(3), init_type="kaiming")
    state = jax_params_to_state_dict(
        {k: {"w": np.asarray(p["w"]) * np.float32(1.5), "b": np.asarray(p["b"])}
         for k, p in params.items()})
    rs = np.random.RandomState(4)
    img = torch.from_numpy(rs.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32))
    sketch = torch.from_numpy((rs.rand(2, 1, 32, 32) > 0.9).astype(np.float32))
    mask = torch.zeros(2, 1, 32, 32)
    mask[:, :, 8:24, 8:24] = 1.0
    cot = torch.from_numpy(rs.randn(2, 3, 32, 32).astype(np.float32))
    grads = {}
    for impl in ("dense", "kernel"):
        net = DeepFillC2Generator(DeepFillConfig(attention_impl=impl))
        net.load_state_dict(state, strict=True)
        _, out = net(img, img, mask, mask, sketch)
        layers = [f"pmconv{i}" for i in ("1", "2_downsample", "3",
                                         "4_downsample", "5", "6")]
        grads[impl] = torch.autograd.grad(
            (out * cot).sum(), [getattr(net, n).weight for n in layers])
    for d, k in zip(grads["dense"], grads["kernel"]):
        assert k.abs().max() > 0
        torch.testing.assert_close(k, d, rtol=1e-4,
                                   atol=1e-4 * d.abs().max().item())


@pytest.mark.parametrize("keep_p", [0.7, 0.0], ids=["gated", "all_gated"])
def test_dv_dk_references_match_pallas_split_kernels(monkeypatch, keep_p):
    """Unaligned 2 x 130 x 150 x 70: the dV and dK plain versions against
    the Pallas single-output kernels (SKETCHEDIT_SPLIT_DKDV=1, interpret
    mode), each within 2e-4 of the gradient's max |value|."""
    monkeypatch.setenv("SKETCHEDIT_SPLIT_DKDV", "1")
    Q, K, V, keep, dO, _ = _core_inputs(5, 2, 130, 150, 70, keep_p)
    jq, jk, jv, jkeep, jdo = map(jnp.asarray, (Q, K, V, keep, dO))
    with pltpu.force_tpu_interpret_mode():
        out, lse = _attention_core_raw(jq, jk, jv, jkeep, return_lse=True,
                                       out_dtype=jnp.float32)
        _, want_dk, want_dv = _attention_core_bwd_pallas(
            jq, jk, jv, jkeep, out, lse, jdo, 10.0)
    t = torch.from_numpy
    out_t, lse_t = t(np.array(out)), t(np.array(lse))
    delta = (t(dO) * out_t).sum(-1)
    got_dv = attention_core_dv_reference(t(Q), t(K), t(keep), lse_t, t(dO))
    got_dk = attention_core_dk_reference(t(Q), t(K), t(V), t(keep), lse_t,
                                         delta, t(dO))
    _close_rel(got_dv.numpy(), want_dv, 2e-4, "dV")
    if keep_p == 0.0:           # all gated: S is multiplied by 0, so no dK
        assert not got_dk.any() and not np.asarray(want_dk).any()
    else:
        _close_rel(got_dk.numpy(), want_dk, 2e-4, "dK")
    # the CPU wrappers are the plain versions and launch nothing; under the
    # switch attention_core_bwd takes them
    before = (attention_cuda.LAUNCHES_DV, attention_cuda.LAUNCHES_DK)
    torch.testing.assert_close(
        attention_core_dv(t(Q), t(K), t(keep), lse_t, t(dO)), got_dv,
        rtol=0, atol=0)
    torch.testing.assert_close(
        attention_core_dk(t(Q), t(K), t(V), t(keep), lse_t, delta, t(dO)),
        got_dk, rtol=0, atol=0)
    assert (attention_cuda.LAUNCHES_DV, attention_cuda.LAUNCHES_DK) == before
    calls = []
    for name in ("attention_core_dq", "attention_core_dv",
                 "attention_core_dk", "attention_core_dkdv",
                 "attention_core_bwd_joint"):
        def spy(*a, _fn=getattr(attention_cuda, name), _n=name, **k):
            calls.append(_n)
            return _fn(*a, **k)
        monkeypatch.setattr(attention_cuda, name, spy)
    split = attention_core_bwd(t(Q), t(K), t(V), t(keep), out_t, lse_t, t(dO))
    assert calls == ["attention_core_dq", "attention_core_dv",
                     "attention_core_dk"]
    monkeypatch.delenv("SKETCHEDIT_SPLIT_DKDV")
    fused = attention_core_bwd(t(Q), t(K), t(V), t(keep), out_t, lse_t, t(dO))
    assert calls[3:] == ["attention_core_bwd_joint"]
    for a, b in zip(split, fused):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_kscale", [True, False])
@pytest.mark.parametrize("route", ["joint", "SKETCHEDIT_SPLIT_DKDV"])
def test_bwd_routes_on_cpu(monkeypatch, route, with_kscale):
    """attention_core_bwd on CPU tensors, with and without kscale: the
    wrappers it calls (by default the joint backward; SKETCHEDIT_SPLIT_DKDV=1
    dQ, dV and dK), no launch counted, and the same gradients as the joint
    plain version: bit for bit by default, within float32 summation order
    otherwise."""
    if route == "joint":
        monkeypatch.delenv("SKETCHEDIT_SPLIT_DKDV", raising=False)
    else:
        monkeypatch.setenv(route, "1")
    Q, K, V, keep, dO, ks = map(torch.from_numpy,
                                _core_inputs(4, 2, 33, 40, 12, 0.6))
    ks = ks if with_kscale else None
    out, lse = attention_cuda.attention_core(Q, K, V, keep, return_lse=True,
                                             kscale=ks)
    calls = []
    for name in ("attention_core_dq", "attention_core_dv",
                 "attention_core_dk", "attention_core_dkdv",
                 "attention_core_bwd_joint"):
        def spy(*a, _fn=getattr(attention_cuda, name), _n=name[15:], **k):
            calls.append(_n)
            return _fn(*a, **k)
        monkeypatch.setattr(attention_cuda, name, spy)
    counters = [c for c in dir(attention_cuda) if c.startswith("LAUNCHES")]
    before = [getattr(attention_cuda, c) for c in counters]
    got = attention_core_bwd(Q, K, V, keep, out, lse, dO, 10.0, ks)
    assert [getattr(attention_cuda, c) for c in counters] == before
    assert calls == (["bwd_joint"] if route == "joint"
                     else ["dq", "dv", "dk"]), calls
    want = attention_core_bwd_joint_reference(
        Q, K, V, keep, lse, (dO * out).sum(-1), dO, 10.0, ks)
    tol = dict(rtol=0, atol=0) if route == "joint" else dict(rtol=1e-5,
                                                             atol=1e-6)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **tol)


@pytest.mark.parametrize("switch", ["SKETCHEDIT_SHARED_ATTN",
                                    "SKETCHEDIT_SPLIT_DKDV"])
def test_fused_gradient_under_switch_matches_jax(monkeypatch, switch):
    """The gradient of contextual_attention_fused under each differentiable
    switch against jax.grad of contextual_attention_pallas under the same
    switch (2e-4 of the gradient's max), and against itself without."""
    rs = np.random.RandomState(31)
    H, C = 16, 12
    f = np.maximum(rs.randn(2, H, H, C), 0).astype(np.float32)
    mask = (rs.rand(2, H, H, 1) > 0.5).astype(np.float32)
    mask[1, : H // 2] = 1.0
    cot = rs.randn(2, H, H, C).astype(np.float32)
    mt = torch.from_numpy(np.ascontiguousarray(mask.transpose(0, 3, 1, 2)))
    cot_t = torch.from_numpy(np.ascontiguousarray(cot.transpose(0, 3, 1, 2)))

    def port_grad():
        ft = torch.from_numpy(np.ascontiguousarray(f.transpose(0, 3, 1, 2))
                              ).requires_grad_()
        out = contextual_attention_fused(ft, ft, mt)
        return torch.autograd.grad((out * cot_t).sum(), ft)[0].numpy(
            ).transpose(0, 2, 3, 1)

    default = port_grad()
    monkeypatch.setenv(switch, "1")

    def loss(x):
        return jnp.sum(contextual_attention_pallas(x, x, jnp.asarray(mask))
                       * cot)
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss)(jnp.asarray(f))
    got = port_grad()
    _close_rel(got, want, 2e-4, switch)
    _close_rel(got, default, 1e-5, switch + " vs default")
