"""Split TF32 emulated in plain torch on the CPU: the helpers that
tests/test_torch_tf32_split_fwd.py (the forwards) and
tests/test_torch_tf32_split_bwd.py (dQ, dK and dV) share, and the main
path's attention inputs with the JAX forward's output on them.

The tensor cores take TF32 operands: 10 mantissa bits, rounded here to
nearest with ties away from zero as ``cvt.rna.tf32.f32`` does. A float32
operand x is split into hi = rna(x) and lo = rna(x - hi); a product of two
float32 operands is three passes (lo hi + hi lo + hi hi), and one whose
other operand holds bfloat16 data (exact in TF32) two. Each pass
accumulates in float32 over 8-deep k steps, as an m16n8k8 mma.sync tile
and an m64nNk8 wgmma both do; every kernel starts each k step's product
afresh and adds it to its running sum in order, which ``mma`` models (the
wgmma forwards' S sums runs of 16 steps apart first: ``group``; the fused
dK/dV's S and dP add those runs with Kahan's compensation: ``compensate``).
"""

import functools

import numpy as np
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sketchedit_tpu.ops.attention_pallas import _attention_core_raw
from sketchedit_tpu_torch.ops.attention_cuda import attention_inputs

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


def mma(a, b, passes=3, group=None, compensate=False):
    """a (B, M, K) @ b (B, K, N) from operand pairs: float32 accumulation
    over 8-deep k steps; ``passes`` 3 for split x split, 2 where one side is
    whole (its lo is None), 1 for hi x hi alone. ``group``: the steps are
    summed apart in runs of that many, each run then added to the total
    (the wgmma forwards' S, 16), with Kahan's compensation where
    ``compensate`` (the fused dK/dV's S and dP); else every step goes to
    the total."""
    (ah, al), (bh, bl) = a, b
    terms = [(ah, bh)]
    if passes > 1:
        terms = ([(al, bh)] if al is not None else []) + \
                ([(ah, bl)] if bl is not None else []) + terms
    B, M, K = ah.shape
    acc = torch.zeros(B, M, bh.shape[2])
    part, n = (torch.zeros_like(acc) if group else acc), 0
    comp = torch.zeros_like(acc)

    def add_run():
        nonlocal acc
        if not compensate:
            acc += part
            return
        y = part - comp
        t = acc + y
        comp.copy_((t - acc) - y)
        acc = t

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
                part += prod[:, i]
            n += 1
            if group and n % group == 0:
                add_run()
                part.zero_()
    if group and n % group:
        add_run()
    return acc - comp


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
