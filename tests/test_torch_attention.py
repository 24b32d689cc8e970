"""Port attention (dense and the kernel's CPU path) against the JAX package's
dense attention and its Pallas kernel, the latter run in interpret mode on
the CPU as tests/test_attention_pallas.py runs it. Tolerance rtol = atol =
2e-4, as the JAX attention tests use (softmax at scale 10 amplifies the
float32 summation-order differences of the similarity)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sketchedit_tpu.ops.attention import contextual_attention as j_dense
from sketchedit_tpu.ops.attention_pallas import (
    _attention_core_dsplit_raw, attention_core_pallas,
    attention_core_pallas_shared, contextual_attention_pallas)
from sketchedit_tpu_torch.ops import attention_cuda
from sketchedit_tpu_torch.ops.attention import contextual_attention
from sketchedit_tpu_torch.ops.attention_cuda import (
    attention_core, attention_core_dsplit, attention_core_dsplit_reference,
    attention_core_reference, attention_core_shared,
    attention_core_shared_reference, contextual_attention_fused, dsplit_cut)

TOL = dict(rtol=2e-4, atol=2e-4)
HIGH = jax.lax.Precision.HIGHEST


def nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _core_inputs(seed, B, N, P, D, keep_p):
    rs = np.random.RandomState(seed)
    Q = rs.randn(B, N, D).astype(np.float32)
    K = rs.randn(B, P, D).astype(np.float32)
    V = rs.randn(B, P, D).astype(np.float32)
    keep = (rs.rand(B, P) < keep_p).astype(np.float32)
    return Q, K, V, keep


@pytest.mark.parametrize("keep_p", [0.7, 0.0], ids=["gated", "all_gated"])
def test_attention_core_reference_matches_pallas(keep_p):
    Q, K, V, keep = _core_inputs(0, 2, 130, 150, 70, keep_p)  # unaligned
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(attention_core_pallas(*map(jnp.asarray,
                                                     (Q, K, V, keep))))
    got, lse = attention_core_reference(*map(torch.from_numpy,
                                             (Q, K, V, keep)),
                                        return_lse=True)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if keep_p == 0.0:   # every logit is 0: uniform weights, lse = log P
        np.testing.assert_allclose(got.numpy(),
                                   np.broadcast_to(V.mean(1, keepdims=True),
                                                   got.shape), **TOL)
        np.testing.assert_allclose(lse.numpy(), np.log(150.0), rtol=1e-6)


def test_attention_core_cpu_takes_plain_version():
    """A CPU tensor takes the plain version: no launch is counted."""
    Q, K, V, keep = map(torch.from_numpy, _core_inputs(1, 1, 20, 24, 8, 0.5))
    before = attention_cuda.LAUNCHES
    got = attention_core(Q, K, V, keep)
    assert attention_cuda.LAUNCHES == before
    torch.testing.assert_close(got, attention_core_reference(Q, K, V, keep),
                               rtol=0, atol=0)


def test_attention_core_kscale_and_out_dtype():
    """kscale scales the keys per channel; out_dtype float32 keeps a
    bfloat16 call's output unrounded."""
    rs = np.random.RandomState(3)
    Q, K, V, keep = map(torch.from_numpy, _core_inputs(3, 2, 30, 40, 12, 0.6))
    kscale = torch.from_numpy(rs.rand(2, 12).astype(np.float32) + 0.5)
    got = attention_core(Q, K, V, keep, kscale=kscale)
    torch.testing.assert_close(
        got, attention_core_reference(Q, K * kscale[:, None, :], V, keep),
        rtol=1e-6, atol=1e-6)
    out = attention_core(Q.bfloat16(), K.bfloat16(), V.bfloat16(), keep,
                         out_dtype=torch.float32)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, attention_core_reference(
        Q.bfloat16().float(), K.bfloat16().float(), V.bfloat16().float(),
        keep), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["dtype", "keep_dtype", "shape",
                                 "contiguous", "out_dtype", "kscale_shape"])
def test_attention_core_rejects_bad_inputs(bad):
    Q, K, V, keep = map(torch.from_numpy, _core_inputs(2, 1, 20, 24, 8, 0.5))
    kw = {}
    if bad == "dtype":
        Q = Q.double()
    elif bad == "keep_dtype":
        keep = keep.bool()
    elif bad == "shape":
        keep = keep[:, :-1]
    elif bad == "contiguous":
        Q = Q.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "out_dtype":
        kw["out_dtype"] = torch.bfloat16     # float32 in, bf16 out: not taken
    else:
        kw["kscale"] = torch.ones(1, 7)
    with pytest.raises((TypeError, ValueError)):
        attention_core(Q, K, V, keep, **kw)


@pytest.mark.parametrize("H", [16, 32])
def test_contextual_attention_matches_jax(H):
    rs = np.random.RandomState(H)
    C = 12
    f = rs.randn(2, H, H, C).astype(np.float32)
    mask = (rs.rand(2, H, H, 1) > 0.5).astype(np.float32)
    mask[1] = 1.0     # second image all hole: every patch gated
    want_dense = np.asarray(j_dense(jnp.asarray(f), jnp.asarray(f),
                                    jnp.asarray(mask), precision=HIGH))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(contextual_attention_pallas(
            jnp.asarray(f), jnp.asarray(f), jnp.asarray(mask)))

    ft, mt = nchw(f), nchw(mask)
    got_dense = nhwc(contextual_attention(ft, ft, mt))
    got_fused = nhwc(contextual_attention_fused(ft, ft, mt))
    np.testing.assert_allclose(got_dense, want_dense, **TOL)
    np.testing.assert_allclose(got_fused, want_pallas, **TOL)
    np.testing.assert_allclose(got_fused, got_dense, **TOL)


def test_contextual_attention_distinct_foreground():
    """f is not b: Q comes from f's patches, K and V from b's."""
    rs = np.random.RandomState(7)
    f = rs.randn(1, 16, 16, 6).astype(np.float32)
    b = rs.randn(1, 16, 16, 6).astype(np.float32)
    mask = (rs.rand(1, 16, 16, 1) > 0.6).astype(np.float32)
    want = np.asarray(j_dense(jnp.asarray(f), jnp.asarray(b),
                              jnp.asarray(mask), precision=HIGH))
    got = nhwc(contextual_attention_fused(nchw(f), nchw(b), nchw(mask)))
    np.testing.assert_allclose(got, want, **TOL)


# The two forward variants' plain versions against the JAX functions in
# interpret mode, at rtol 1e-4 / atol 1e-5. Q carries 1 / sqrt(D), so the
# logits spread over about +-10 as in the model; unit-variance Q and K put
# them near +-100, where a summation-order difference in S of 1e-5 moves a
# near-tied weight by more than this tolerance.
VARIANT_TOL = dict(rtol=1e-4, atol=1e-5)
VARIANT_CASES = [pytest.param(2, 130, 150, 70, 0.7, id="gated_ragged"),
                 pytest.param(2, 130, 150, 70, 0.0, id="all_gated_ragged"),
                 pytest.param(1, 128, 128, 256, 0.6, id="gated_aligned")]


@pytest.mark.parametrize("B,N,P,D,keep_p", VARIANT_CASES)
def test_dsplit_reference_matches_pallas(B, N, P, D, keep_p):
    Q, K, V, keep = _core_inputs(10, B, N, P, D, keep_p)
    Q = Q * np.float32(D ** -0.5)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = _attention_core_dsplit_raw(
            *map(jnp.asarray, (Q, K, V, keep)), return_lse=True)
    got, lse = attention_core_dsplit_reference(
        *map(torch.from_numpy, (Q, K, V, keep)), return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VARIANT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               **VARIANT_TOL)
    # the wrapper on the CPU is the plain version, launches nothing, and
    # equals the undivided plain version wherever the cut falls
    before = attention_cuda.LAUNCHES_DSPLIT
    wrapped = attention_core_dsplit(*map(torch.from_numpy, (Q, K, V, keep)))
    assert attention_cuda.LAUNCHES_DSPLIT == before
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
    torch.testing.assert_close(got, attention_core_reference(
        *map(torch.from_numpy, (Q, K, V, keep))), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("D,cut", [(1536, 768), (70, 36), (3, 4), (8, 4),
                                   (9, 8)])
def test_dsplit_cut(D, cut):
    assert dsplit_cut(D) == cut


@pytest.mark.parametrize("B,N,P,D,keep_p", [
    pytest.param(2, 150, 150, 70, 0.7, id="gated_ragged"),
    pytest.param(2, 150, 150, 70, 0.0, id="all_gated_ragged"),
    pytest.param(1, 128, 128, 256, 0.6, id="gated_aligned")])
def test_shared_reference_matches_pallas(B, N, P, D, keep_p):
    rs = np.random.RandomState(11)
    _, _, V, keep = _core_inputs(11, B, N, P, D, keep_p)
    kscale = ((0.5 + rs.rand(B, D)) * D ** -0.5).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = attention_core_pallas_shared(*map(jnp.asarray,
                                                 (V, kscale, keep)))
    tv, tks, tkeep = map(torch.from_numpy, (V, kscale, keep))
    got = attention_core_shared_reference(tv, tks, tkeep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VARIANT_TOL)
    before = attention_cuda.LAUNCHES_SHARED
    wrapped, lse = attention_core_shared(tv, tks, tkeep, return_lse=True)
    assert attention_cuda.LAUNCHES_SHARED == before
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
    assert lse.shape == (B, N) and lse.dtype == torch.float32
    with pytest.raises(ValueError, match="kscale"):
        attention_core_shared(tv, None, tkeep)


@pytest.mark.parametrize("switch", ["SKETCHEDIT_SHARED_ATTN",
                                    "SKETCHEDIT_DSPLIT_ATTN"])
def test_fused_under_forward_switch_matches_jax_and_default(monkeypatch,
                                                            switch):
    """contextual_attention_fused under each forward switch equals the JAX
    function under the same switch, and itself without the switch."""
    rs = np.random.RandomState(21)
    f = rs.randn(2, 16, 16, 12).astype(np.float32)
    mask = (rs.rand(2, 16, 16, 1) > 0.5).astype(np.float32)
    mask[1] = 1.0
    ft, mt = nchw(f), nchw(mask)
    default = nhwc(contextual_attention_fused(ft, ft, mt))
    monkeypatch.setenv(switch, "1")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(contextual_attention_pallas(
            jnp.asarray(f), jnp.asarray(f), jnp.asarray(mask)))
    with torch.no_grad():
        got = nhwc(contextual_attention_fused(ft, ft, mt))
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, default, rtol=1e-6, atol=1e-6)


def test_switch_precedence_and_dsplit_refuses_a_gradient(monkeypatch):
    """As in the JAX package: the shared kernel only where f is b, then the
    D-split where set, else the default; the D-split has no backward and
    raises, naming the switch, where a gradient is asked."""
    rs = np.random.RandomState(22)
    f, b = (nchw(rs.randn(1, 16, 16, 6).astype(np.float32)) for _ in range(2))
    mask = nchw((rs.rand(1, 16, 16, 1) > 0.6).astype(np.float32))
    calls = []
    for name in ("attention_core", "attention_core_shared",
                 "attention_core_dsplit"):
        def spy(*a, _fn=getattr(attention_cuda, name), _n=name, **k):
            calls.append(_n)
            return _fn(*a, **k)
        monkeypatch.setattr(attention_cuda, name, spy)

    def taken(x, y, **env):
        for k in ("SKETCHEDIT_SHARED_ATTN", "SKETCHEDIT_DSPLIT_ATTN"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        calls.clear()
        with torch.no_grad():
            contextual_attention_fused(x, y, mask)
        return calls[:]

    both = dict(SKETCHEDIT_SHARED_ATTN="1", SKETCHEDIT_DSPLIT_ATTN="1")
    assert taken(f, f) == ["attention_core"]
    assert taken(f, f, **both) == ["attention_core_shared"]
    assert taken(f, b, **both) == ["attention_core_dsplit"]
    assert taken(f, b, SKETCHEDIT_SHARED_ATTN="1") == ["attention_core"]
    assert taken(f, f, SKETCHEDIT_DSPLIT_ATTN="1") == ["attention_core_dsplit"]
    assert taken(f, f, SKETCHEDIT_SHARED_ATTN="0") == ["attention_core"]
    monkeypatch.setenv("SKETCHEDIT_DSPLIT_ATTN", "1")
    monkeypatch.delenv("SKETCHEDIT_SHARED_ATTN")
    with pytest.raises(RuntimeError, match="SKETCHEDIT_DSPLIT_ATTN"):
        contextual_attention_fused(f.requires_grad_(), f, mask)
