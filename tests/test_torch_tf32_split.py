"""Split TF32, the precision scheme of the default and shared forward kernels
(``csrc/contextual_attention_fwd.cu``) and of the dQ backward kernel
(``csrc/contextual_attention_bwd.cu``), emulated in plain torch on the CPU
and held against the JAX package's forward and dQ.

mma.sync takes TF32 operands: 10 mantissa bits, rounded here to nearest
with ties away from zero as ``cvt.rna.tf32.f32`` does. A float32 operand x
is split into hi = rna(x) and lo = rna(x - hi); a product of two float32
operands is three passes (lo hi + hi lo + hi hi), and one whose other
operand holds bfloat16 data (exact in TF32) two. Each pass accumulates in
float32 over 8-deep k steps, as an m16n8k8 tile does. The emulation runs the
forward's S -> softmax -> P V on the main path's inputs at 64^2 features
(256^2 images: N = P = 961, D = 1536) with kscale where each kernel puts
it, and must agree with ``_attention_core_raw`` (interpret mode) within
chip_smoke.py's float32 tolerance, 1e-4, for float32 and bfloat16 inputs.
One-pass TF32 on the same inputs misses that tolerance, which is why the
kernels split. The dQ emulation runs S, dP and dS K the same way (kscale on
the query side of S, K raw; dO always split) on the same inputs with a
seeded dO and the JAX forward's lse and delta, and must agree with
``_attention_core_bwd_pallas``'s dQ (interpret mode) within chip_smoke.py's
BWD_TOL, 2e-4 of max |dQ|. The dK and dV emulations run the single-output
kernels' products (S^T = (K kscale) Q^T with kscale on the owned keys, dP^T
= K dO^T with the keys raw, then dS^T Q or P^T dO) on the same inputs and
must agree with the same function's dK and dV under SKETCHEDIT_SPLIT_DKDV=1
(its ``_dk_kernel`` and ``_dv_kernel``) within BWD_TOL. The D-split
emulation runs the D-split kernel's forward: kscale on the query rows,
each half of D contracted apart into a partial S (the two blocks of a
cluster), S = own + peer, then P V for each half's columns; it must agree
with ``_attention_core_dsplit_raw`` (interpret mode) within the same TOL,
1e-4, for float32 and bfloat16 inputs, where one pass misses it.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sketchedit_tpu.ops.attention_pallas import (
    _attention_core_bwd_pallas, _attention_core_dsplit_raw,
    _attention_core_raw)
from sketchedit_tpu_torch.ops.attention_cuda import (
    attention_inputs, dsplit_cut)

TOL = 1e-4          # chip_smoke.py's TOL[float32]
BWD_TOL = 2e-4      # chip_smoke.py's BWD_TOL, a share of max |dQ|
SCALE = 10.0


def tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero: add half of the 13 dropped bits' range to the magnitude, then
    clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def operand(x, split):
    """x as (hi, lo) TF32 terms, or whole (lo None) where it is exact."""
    if not split:
        return x, None
    hi = tf32(x)
    return hi, tf32(x - hi)


def mma(a, b, passes=3):
    """a (B, M, K) @ b (B, K, N) from operand pairs: float32 accumulation
    over 8-deep k steps; ``passes`` 3 for split x split, 2 where one side is
    whole (its lo is None), 1 for hi x hi alone."""
    (ah, al), (bh, bl) = a, b
    terms = [(ah, bh)]
    if passes > 1:
        terms = ([(al, bh)] if al is not None else []) + \
                ([(ah, bl)] if bl is not None else []) + terms
    B, M, K = ah.shape
    acc = torch.zeros(B, M, bh.shape[2])
    # the 8-deep products of `chunk` k steps at once, added in order
    chunk = 8
    for k0 in range(0, K, 8 * chunk):
        k1 = min(K, k0 + 8 * chunk)
        steps = -(-(k1 - k0) // 8)
        prods = []
        for x, y in terms:
            xs, ys = x[:, :, k0:k1], y[:, k0:k1]
            if (k1 - k0) % 8:                   # a short last step
                pad = 8 * steps - (k1 - k0)
                xs = torch.nn.functional.pad(xs, (0, pad))
                ys = torch.nn.functional.pad(ys, (0, 0, 0, pad))
            prods.append(torch.matmul(
                xs.reshape(B, M, steps, 8).transpose(1, 2),
                ys.reshape(B, steps, 8, -1)))
        for i in range(steps):
            for prod in prods:
                acc += prod[:, i]
    return acc


def emulated_forward(Q, V, keep, kscale, variant, one_pass=False):
    """O of ``attention_core(Q, V, V, keep, kscale=kscale)`` (keys V *
    kscale) as the kernel computes it: kscale on the query rows (default,
    dsplit) or on the keys (shared), both formed in float32; operands split
    where they hold float32 values. dsplit contracts each half of D apart
    and sums the two partial S, then forms each half's columns of P V."""
    f32 = Q.dtype == torch.float32
    Qf, Vf = Q.float(), V.float()
    passes = 1 if one_pass else 3
    if variant == "dsplit":
        # each block of a cluster contracts its half of D; S = own + peer
        A, cut = Qf * kscale[:, None, :], dsplit_cut(Q.shape[2])
        halves = [(0, cut), (cut, Q.shape[2])]
        S = sum(mma(operand(A[..., lo:hi], True),
                    operand(Vf[..., lo:hi].transpose(1, 2), f32 or one_pass),
                    passes) for lo, hi in halves)
        logit = S * keep[:, None, :] * SCALE
        p = torch.exp(logit - logit.amax(-1, keepdim=True))
        out = torch.cat([mma(operand(p, True),
                             operand(Vf[..., lo:hi], f32 or one_pass), passes)
                         for lo, hi in halves], dim=-1)
        return out / p.sum(-1, keepdim=True)
    if variant == "default":
        A, Bk = Qf * kscale[:, None, :], Vf
        split_a, split_b = True, f32
    else:
        A, Bk = Qf, Vf * kscale[:, None, :]
        split_a, split_b = f32, True
    S = mma(operand(A, split_a or one_pass),
            operand(Bk.transpose(1, 2), split_b or one_pass), passes)
    logit = S * keep[:, None, :] * SCALE
    p = torch.exp(logit - logit.amax(-1, keepdim=True))
    out = mma(operand(p, True), operand(Vf, f32 or one_pass), passes)
    return out / p.sum(-1, keepdim=True)


@functools.lru_cache(maxsize=None)
def case(dtype_name):
    """The main path's attention inputs at 64^2 features (seeded numpy), in
    the given dtype, and the JAX forward's float32 output and logsumexp on
    them."""
    rs = np.random.RandomState(7)
    B, C, H = 1, 96, 64
    # non-negative gated-like pm features (pmconv6 ends in relu * sigmoid)
    f = np.maximum(rs.randn(B, C, H, H), 0) / (1 + np.exp(-rs.randn(B, C, H, H)))
    mask = np.zeros((B, 1, H, H), np.float32)
    h = int(H * 0.4)                         # a hole in the middle
    mask[:, :, (H - h) // 2:(H + h) // 2, (H - h) // 2:(H + h) // 2] = 1.0
    feats = torch.from_numpy(f.astype(np.float32)).to(getattr(torch, dtype_name))
    Q, V, keep, kscale = attention_inputs(feats, feats, torch.from_numpy(mask))
    K = V.float() * kscale[:, None, :]       # the keys, float32
    with pltpu.force_tpu_interpret_mode():
        want, lse = _attention_core_raw(
            jnp.asarray(Q.float().numpy()), jnp.asarray(K.numpy()),
            jnp.asarray(V.float().numpy()), jnp.asarray(keep.numpy()),
            softmax_scale=SCALE, return_lse=True, out_dtype=jnp.float32)
    return (Q, V, keep, kscale, torch.from_numpy(np.array(want)),
            torch.from_numpy(np.array(lse)))


def test_tf32_rounding_keeps_10_mantissa_bits():
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(
        np.float32) * 1e3)
    hi, lo = operand(x, True)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((hi - x).abs() <= 2.0 ** -11 * x.abs()).all()
    assert ((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all()
    # ties go away from zero: 1 + 2^-11 lies halfway between TF32 neighbours
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    assert tf32(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]
    # bfloat16 data is exact in TF32
    b = x.bfloat16().float()
    assert torch.equal(tf32(b), b)


@functools.lru_cache(maxsize=None)
def dsplit_case(dtype_name):
    """The JAX D-split forward's float32 output on case()'s inputs (float32
    values of the inputs, as there)."""
    Q, V, keep, kscale, _, _ = case(dtype_name)
    K = V.float() * kscale[:, None, :]
    with pltpu.force_tpu_interpret_mode():
        want = _attention_core_dsplit_raw(
            jnp.asarray(Q.float().numpy()), jnp.asarray(K.numpy()),
            jnp.asarray(V.float().numpy()), jnp.asarray(keep.numpy()),
            softmax_scale=SCALE, out_dtype=jnp.float32)
    return torch.from_numpy(np.array(want))


@pytest.mark.parametrize("variant", ["default", "shared", "dsplit"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_split_tf32_forward_matches_jax(dtype_name, variant):
    Q, V, keep, kscale, want, _ = case(dtype_name)
    if variant == "dsplit":
        want = dsplit_case(dtype_name)
    assert Q.shape == (1, 961, 1536) and 0 < keep.sum() < 961
    got = emulated_forward(Q, V, keep, kscale, variant)
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    # one pass on rounded operands misses the same tolerance
    one = emulated_forward(Q, V, keep, kscale, variant, one_pass=True)
    one_err = (one - want).abs().max().item()
    print(dtype_name, variant, "split", err, "one pass", one_err)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(one, want, rtol=TOL, atol=TOL)


def emulated_dq(Q, V, keep, kscale, lse, delta, dO, one_pass=False):
    """dQ of ``attention_core(Q, V, V, keep, kscale=kscale)`` as the dQ
    kernel computes it: S = (Q kscale) V^T with kscale on the query side
    and the keys raw, dP = dO V^T, dS = P (dP - delta) g with P = exp(S g -
    lse) and g = keep * scale, dQ = (dS V) kscale; Q kscale, dO and dS are
    split, V is split where it holds float32 values."""
    f32 = Q.dtype == torch.float32
    Kf = V.float()
    passes = 1 if one_pass else 3
    S = mma(operand(Q.float() * kscale[:, None, :], True),
            operand(Kf.transpose(1, 2), f32 or one_pass), passes)
    dP = mma(operand(dO, True), operand(Kf.transpose(1, 2), f32 or one_pass),
             passes)
    g = keep[:, None, :] * SCALE
    dS = torch.exp(S * g - lse[..., None]) * (dP - delta[..., None]) * g
    return mma(operand(dS, True), operand(Kf, f32 or one_pass),
               passes) * kscale[:, None, :]


@functools.lru_cache(maxsize=None)
def dq_case(dtype_name):
    """case()'s inputs with a seeded dO, delta = rowsum(dO O) from the JAX
    forward, and the JAX package's dQ on them (float32 values of the
    inputs, as the forward's case)."""
    Q, V, keep, kscale, out, lse = case(dtype_name)
    dO = torch.from_numpy(np.random.RandomState(8).randn(*Q.shape).astype(
        np.float32))
    K = V.float() * kscale[:, None, :]
    with pltpu.force_tpu_interpret_mode():
        dq = _attention_core_bwd_pallas(
            jnp.asarray(Q.float().numpy()), jnp.asarray(K.numpy()),
            jnp.asarray(V.float().numpy()), jnp.asarray(keep.numpy()),
            jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()),
            jnp.asarray(dO.numpy()), SCALE)[0]
    return dO, (dO * out).sum(-1), torch.from_numpy(np.array(dq))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_split_tf32_dq_matches_jax(dtype_name):
    Q, V, keep, kscale, _, lse = case(dtype_name)
    dO, delta, want = dq_case(dtype_name)
    scale = want.abs().max().item()
    assert want.shape == (1, 961, 1536) and scale > 0
    got = emulated_dq(Q, V, keep, kscale, lse, delta, dO)
    err = (got - want).abs().max().item() / scale
    one = emulated_dq(Q, V, keep, kscale, lse, delta, dO, one_pass=True)
    one_err = (one - want).abs().max().item() / scale
    print(dtype_name, "dQ split", err, "one pass", one_err,
          "(shares of max |dQ|)")
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
