"""Split TF32 in the backward kernels (``csrc/contextual_attention_bwd.cu``),
emulated in plain torch on the CPU (tests/tf32_emulation.py) and held
against the JAX package's dQ, dK and dV.

The dQ emulation runs S, dP and dS K the way dQ's wgmma sequence does
(kscale on the query side of S, K raw; dO always split; S and dP each
summed in runs of 16 k8 steps added to the total with Kahan's
compensation; dS K every step to the total, kscale on dQ's columns at the
end) on the main path's inputs at 64^2 features (256^2 images: N = P =
961, D = 1536) with a seeded dO and the JAX forward's lse and delta, and
must agree with ``_attention_core_bwd_pallas``'s dQ (interpret mode)
within chip_smoke.py's BWD_TOL, 2e-4 of max |dQ|; so must its first 481
query rows alone (the sharded path's query slice, N apart from P) against
the JAX function's dQ for that slice. The joint backward's dQ is the same
dS K taken over chunks of keys, each chunk's product scaled by kscale and
added to the earlier chunks' sum; emulated over chunks of 384 keys from
the same dS, it must agree with the JAX dQ within BWD_TOL too. The dK and
dV emulations run
the single-output kernels' products (S^T = (K kscale) Q^T with kscale on
the owned keys, dP^T = K dO^T with the keys raw, then dS^T Q or P^T dO)
on the same inputs and must agree with the same function's dK and dV
under SKETCHEDIT_SPLIT_DKDV=1 (its ``_dk_kernel`` and ``_dv_kernel``)
within BWD_TOL. The fused dK/dV emulation runs the wgmma sequence's four
products (S = (Q kscale) K^T and dP = dO V^T over D, each summed in runs
of 16 k8 steps added to the total with Kahan's compensation; then P^T dO
and dS^T Q over the queries, every step to the total) and must agree with the same function's default dK and dV (its
``_dkdv_kernel``) within BWD_TOL.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sketchedit_tpu.ops.attention_pallas import _attention_core_bwd_pallas
from tf32_emulation import BWD_TOL, SCALE, case, mma, operand


def emulated_ds(Q, V, keep, kscale, lse, delta, dO, one_pass=False):
    """dS of ``attention_core(Q, V, V, keep, kscale=kscale)`` as dQ's and
    the fused dK/dV's wgmma sequences form it: S = (Q kscale) V^T with
    kscale on the query side and the keys raw, dP = dO V^T, both summed in
    runs of 16 k8 steps added to the total with Kahan's compensation; dS =
    P (dP - delta) g with P = exp(S g - lse) and g = keep * scale; Q kscale
    and dO are split, V is split where it holds float32 values."""
    f32 = Q.dtype == torch.float32
    Kf = V.float()
    passes = 1 if one_pass else 3
    S = mma(operand(Q.float() * kscale[:, None, :], True),
            operand(Kf.transpose(1, 2), f32 or one_pass), passes, group=16,
            compensate=True)
    dP = mma(operand(dO, True), operand(Kf.transpose(1, 2), f32 or one_pass),
             passes, group=16, compensate=True)
    g = keep[:, None, :] * SCALE
    return torch.exp(S * g - lse[..., None]) * (dP - delta[..., None]) * g


def emulated_dq_from_ds(dS, V, kscale, one_pass=False, chunk=None):
    """dQ = (dS V) kscale as dQ's product computes it: dS split, V split
    where it holds float32 values, every step added to the total, kscale on
    the columns at the end. With ``chunk``, as the joint backward computes
    it: each chunk of that many keys its own product, scaled by kscale and
    added in order to the sum of the earlier chunks' (the first stored)."""
    f32 = V.dtype == torch.float32
    Kf, passes = V.float(), 1 if one_pass else 3
    P = Kf.shape[1]
    dq = None
    for r0 in range(0, P, chunk or P):
        r1 = min(P, r0 + (chunk or P))
        part = mma(operand(dS[:, :, r0:r1].contiguous(), True),
                   operand(Kf[:, r0:r1], f32 or one_pass),
                   passes) * kscale[:, None, :]
        dq = part if dq is None else dq + part
    return dq


def emulated_dq(Q, V, keep, kscale, lse, delta, dO, one_pass=False):
    """dQ of ``attention_core(Q, V, V, keep, kscale=kscale)`` as dQ's wgmma
    sequence computes it: ``emulated_ds``, then ``emulated_dq_from_ds``."""
    dS = emulated_ds(Q, V, keep, kscale, lse, delta, dO, one_pass)
    return emulated_dq_from_ds(dS, V, kscale, one_pass)


@functools.lru_cache(maxsize=None)
def dq_case(dtype_name):
    """case()'s inputs with a seeded dO, delta = rowsum(dO O) from the JAX
    forward, and the JAX package's dQ, dK and dV on them from its default
    kernels (``_dq_kernel``, ``_dkdv_kernel``; float32 values of the inputs,
    as the forward's case)."""
    assert os.environ.get("SKETCHEDIT_SPLIT_DKDV") != "1"
    Q, V, keep, kscale, out, lse = case(dtype_name)
    dO = torch.from_numpy(np.random.RandomState(8).randn(*Q.shape).astype(
        np.float32))
    K = V.float() * kscale[:, None, :]
    with pltpu.force_tpu_interpret_mode():
        grads = _attention_core_bwd_pallas(
            jnp.asarray(Q.float().numpy()), jnp.asarray(K.numpy()),
            jnp.asarray(V.float().numpy()), jnp.asarray(keep.numpy()),
            jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()),
            jnp.asarray(dO.numpy()), SCALE)
    return (dO, (dO * out).sum(-1),
            *(torch.from_numpy(np.array(g)) for g in grads))


@functools.lru_cache(maxsize=None)
def main_ds(dtype_name):
    """The emulated dS at case()'s inputs and dq_case()'s dO and delta,
    formed once for the tests that take dQ from it."""
    Q, V, keep, kscale, _, lse = case(dtype_name)
    dO, delta, _, _, _ = dq_case(dtype_name)
    return emulated_ds(Q, V, keep, kscale, lse, delta, dO)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_split_tf32_dq_matches_jax(dtype_name, monkeypatch):
    monkeypatch.delenv("SKETCHEDIT_SPLIT_DKDV", raising=False)
    Q, V, keep, kscale, _, lse = case(dtype_name)
    dO, delta, want, _, _ = dq_case(dtype_name)
    scale = want.abs().max().item()
    assert want.shape == (1, 961, 1536) and scale > 0
    got = emulated_dq_from_ds(main_ds(dtype_name), V, kscale)
    err = (got - want).abs().max().item() / scale
    one = emulated_dq(Q, V, keep, kscale, lse, delta, dO, one_pass=True)
    one_err = (one - want).abs().max().item() / scale
    print(dtype_name, "dQ split", err, "one pass", one_err,
          "(shares of max |dQ|)")
    torch.testing.assert_close(got, want, rtol=0, atol=BWD_TOL * scale)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_split_tf32_joint_dq_over_key_chunks_matches_jax(dtype_name,
                                                         monkeypatch):
    """The joint backward's dQ over chunks of 384 keys (961 = 384 + 384 +
    193), kscale on each chunk's product and the chunks added in order,
    from the same emulated dS, against the JAX dQ within BWD_TOL; and
    within float32 summation order of the one-chunk dQ."""
    monkeypatch.delenv("SKETCHEDIT_SPLIT_DKDV", raising=False)
    _, V, _, kscale, _, _ = case(dtype_name)
    _, _, want, _, _ = dq_case(dtype_name)
    scale = want.abs().max().item()
    dS = main_ds(dtype_name)
    got = emulated_dq_from_ds(dS, V, kscale, chunk=384)
    one = emulated_dq_from_ds(dS, V, kscale)
    print(dtype_name, "joint dQ over 384-key chunks",
          (got - want).abs().max().item() / scale, "against one chunk",
          (got - one).abs().max().item() / scale, "(shares of max |dQ|)")
    torch.testing.assert_close(got, want, rtol=0, atol=BWD_TOL * scale)
    torch.testing.assert_close(got, one, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_split_tf32_dq_query_slice_matches_jax(dtype_name, monkeypatch):
    """The first 481 of 961 query rows against the whole key bank, as the
    query-sharded path calls the backward: the JAX function's dQ for that
    slice alone, against the emulation's."""
    monkeypatch.delenv("SKETCHEDIT_SPLIT_DKDV", raising=False)
    Q, V, keep, kscale, out, lse = case(dtype_name)
    dO, delta, _, _, _ = dq_case(dtype_name)
    n = 481
    Qs, dOs, outs = (t[:, :n].contiguous() for t in (Q, dO, out))
    K = V.float() * kscale[:, None, :]
    with pltpu.force_tpu_interpret_mode():
        want = _attention_core_bwd_pallas(
            jnp.asarray(Qs.float().numpy()), jnp.asarray(K.numpy()),
            jnp.asarray(V.float().numpy()), jnp.asarray(keep.numpy()),
            jnp.asarray(outs.numpy()), jnp.asarray(lse[:, :n].numpy()),
            jnp.asarray(dOs.numpy()), SCALE)[0]
    want = torch.from_numpy(np.array(want))
    scale = want.abs().max().item()
    assert want.shape == (1, n, 1536) and scale > 0
    got = emulated_dq(Qs, V, keep, kscale, lse[:, :n], delta[:, :n], dOs)
    print(dtype_name, "dQ query slice split",
          (got - want).abs().max().item() / scale, "(share of max |dQ|)")
    torch.testing.assert_close(got, want, rtol=0, atol=BWD_TOL * scale)


def emulated_dk_dv(Q, V, keep, kscale, lse, delta, dO, one_pass=False):
    """(dK_eff, dV) of ``attention_core(Q, V, V, keep, kscale=kscale)`` as
    the dK and dV kernels compute them, keys owned and queries streamed:
    S^T = (K kscale) Q^T with kscale on the owned keys (split) and Q split
    where it holds float32 values; dP^T = K dO^T with the keys raw (split
    where they hold float32 values) and dO split; P^T = exp(S^T g - lse)
    and dS^T = P^T (dP^T - delta) g with g = keep * scale per key; dK_eff =
    dS^T Q and dV = P^T dO, the weights split, Q split where it holds
    float32 values, dO split."""
    f32 = Q.dtype == torch.float32
    Kf, Qf = V.float(), Q.float()
    passes = 1 if one_pass else 3
    ST = mma(operand(Kf * kscale[:, None, :], True),
             operand(Qf.transpose(1, 2), f32 or one_pass), passes)
    dPT = mma(operand(Kf, f32 or one_pass),
              operand(dO.transpose(1, 2), True), passes)
    g = keep[:, :, None] * SCALE
    PT = torch.exp(ST * g - lse[:, None, :])
    dST = PT * (dPT - delta[:, None, :]) * g
    return (mma(operand(dST, True), operand(Qf, f32 or one_pass), passes),
            mma(operand(PT, True), operand(dO, True), passes))


@functools.lru_cache(maxsize=None)
def split_case(dtype_name):
    """dq_case()'s seeded dO and delta, and the JAX package's dK and dV from
    its single-output kernels on them (the caller sets
    SKETCHEDIT_SPLIT_DKDV=1, which the JAX function reads per call)."""
    assert os.environ.get("SKETCHEDIT_SPLIT_DKDV") == "1"
    Q, V, keep, kscale, out, lse = case(dtype_name)
    dO = torch.from_numpy(np.random.RandomState(8).randn(*Q.shape).astype(
        np.float32))
    K = V.float() * kscale[:, None, :]
    with pltpu.force_tpu_interpret_mode():
        _, dk, dv = _attention_core_bwd_pallas(
            jnp.asarray(Q.float().numpy()), jnp.asarray(K.numpy()),
            jnp.asarray(V.float().numpy()), jnp.asarray(keep.numpy()),
            jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()),
            jnp.asarray(dO.numpy()), SCALE)
    return (dO, (dO * out).sum(-1), torch.from_numpy(np.array(dk)),
            torch.from_numpy(np.array(dv)))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_split_tf32_dk_dv_match_jax(dtype_name, monkeypatch):
    monkeypatch.setenv("SKETCHEDIT_SPLIT_DKDV", "1")
    Q, V, keep, kscale, _, lse = case(dtype_name)
    dO, delta, want_dk, want_dv = split_case(dtype_name)
    args = (Q, V, keep, kscale, lse, delta, dO)
    got = emulated_dk_dv(*args)
    one = emulated_dk_dv(*args, one_pass=True)
    for name, g, o, want in zip(("dK_eff", "dV"), got, one,
                                (want_dk, want_dv)):
        scale = want.abs().max().item()
        assert want.shape == (1, 961, 1536) and scale > 0, name
        print(dtype_name, name, "split", (g - want).abs().max().item() / scale,
              "one pass", (o - want).abs().max().item() / scale,
              "(shares of max |.|)")
        torch.testing.assert_close(g, want, rtol=0, atol=BWD_TOL * scale,
                                   msg=lambda m, n=name: f"{n}: {m}")


def emulated_dkdv(Q, V, keep, kscale, lse, delta, dO, one_pass=False):
    """(dK_eff, dV) of ``attention_core(Q, V, V, keep, kscale=kscale)`` as
    the fused dK/dV's wgmma sequence computes them: S = (Q kscale) K^T with
    kscale on the query rows (split) and the keys raw (split where they
    hold float32 values), dP = dO V^T (dO split), both summed in runs of 16
    k8 steps added to the total with Kahan's compensation; P = exp(S g -
    lse) and dS = P (dP - delta) g with g = keep * scale per key; dV = P^T dO and dK_eff = dS^T Q over the queries, P^T,
    dS^T and dO split, Q split where it holds float32 values, every step
    added to the total."""
    f32 = Q.dtype == torch.float32
    Kf, Qf = V.float(), Q.float()
    passes = 1 if one_pass else 3
    S = mma(operand(Qf * kscale[:, None, :], True),
            operand(Kf.transpose(1, 2), f32 or one_pass), passes, group=16,
            compensate=True)
    dP = mma(operand(dO, True), operand(Kf.transpose(1, 2), f32 or one_pass),
             passes, group=16, compensate=True)
    g = keep[:, None, :] * SCALE
    P = torch.exp(S * g - lse[..., None])
    dS = P * (dP - delta[..., None]) * g
    return (mma(operand(dS.transpose(1, 2), True), operand(Qf, f32 or one_pass),
                passes),
            mma(operand(P.transpose(1, 2), True), operand(dO, True), passes))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_split_tf32_dkdv_matches_jax(dtype_name, monkeypatch):
    monkeypatch.delenv("SKETCHEDIT_SPLIT_DKDV", raising=False)
    Q, V, keep, kscale, _, lse = case(dtype_name)
    dO, delta, _, want_dk, want_dv = dq_case(dtype_name)
    args = (Q, V, keep, kscale, lse, delta, dO)
    got = emulated_dkdv(*args)
    one = emulated_dkdv(*args, one_pass=True)
    for name, g, o, want in zip(("dK_eff", "dV"), got, one,
                                (want_dk, want_dv)):
        scale = want.abs().max().item()
        assert want.shape == (1, 961, 1536) and scale > 0, name
        print(dtype_name, name, "fused split", (g - want).abs().max().item()
              / scale, "one pass", (o - want).abs().max().item() / scale,
              "(shares of max |.|)")
        torch.testing.assert_close(g, want, rtol=0, atol=BWD_TOL * scale,
                                   msg=lambda m, n=name: f"{n}: {m}")
