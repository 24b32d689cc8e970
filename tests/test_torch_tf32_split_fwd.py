"""Split TF32, the precision scheme of the attention forward kernels
(``csrc/contextual_attention_fwd.cu``), emulated in plain torch on the CPU
(tests/tf32_emulation.py) and held against the JAX package's forwards.

The emulation runs the forward's S -> softmax -> P V on the main path's
inputs at 64^2 features (256^2 images: N = P = 961, D = 1536) with kscale
on the query rows, where every forward kernel puts it, and must agree
with ``_attention_core_raw`` (interpret mode) within chip_smoke.py's
float32 tolerance, 1e-4, for float32 and bfloat16 inputs. The default and
shared kernels (wgmma) compute P = exp(logit - m) with m the row's max and
divide P V by the row's sum, which the emulation does; the D-split's
online softmax gives the same values to float32 rounding. One-pass TF32
on the same inputs misses that tolerance, which is why the kernels split.
The D-split emulation runs the D-split kernel's forward: each half of D
contracted apart into a partial S (the two blocks of a cluster), S = own +
peer, then P V for each half's columns; it must agree with
``_attention_core_dsplit_raw`` (interpret mode) within the same TOL, 1e-4,
for float32 and bfloat16 inputs, where one pass misses it.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sketchedit_tpu.ops.attention_pallas import _attention_core_dsplit_raw
from sketchedit_tpu_torch.ops.attention_cuda import dsplit_cut
from tf32_emulation import SCALE, TOL, case, mma, operand, tf32


def emulated_forward(Q, V, keep, kscale, variant, one_pass=False):
    """O of ``attention_core(Q, V, V, keep, kscale=kscale)`` (keys V *
    kscale) as the kernel computes it: kscale on the query rows (all
    three), formed in float32; operands split where they hold float32
    values. dsplit contracts each half of D apart and sums the two partial
    S, then forms each half's columns of P V; default and shared (one
    computation on one tensor) contract all of D at once, summing S's k
    steps in runs of 16."""
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
    S = mma(operand(Qf * kscale[:, None, :], True),
            operand(Vf.transpose(1, 2), f32 or one_pass), passes, group=16)
    logit = S * keep[:, None, :] * SCALE
    p = torch.exp(logit - logit.amax(-1, keepdim=True))
    out = mma(operand(p, True), operand(Vf, f32 or one_pass), passes)
    return out / p.sum(-1, keepdim=True)


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
