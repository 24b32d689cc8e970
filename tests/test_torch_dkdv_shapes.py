"""The plain version of the fused dK/dV kernel against the JAX package's
Pallas backward (``_attention_core_bwd_pallas`` in interpret mode, as
tests/test_attention_grad.py runs it) at the shapes where the kernel's
tiles go ragged: N and P off the 64-query and 16- or 8-key tiles, D odd,
not a multiple of 8 and below the cut between a cluster's two halves, all
keys gated, and kscale on the keys.

The kernel itself needs the card; tests/test_torch_kernels.py holds it to
this plain version there. Tolerance: rtol = atol = 2e-4, both sides the
same function in float32 (the JAX attention tests' tolerance).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from sketchedit_tpu.ops.attention_pallas import (
    _attention_core_bwd_pallas, _attention_core_raw)
from sketchedit_tpu_torch.ops.attention_cuda import (
    attention_core_dkdv, attention_core_dkdv_reference)

TOL = dict(rtol=2e-4, atol=2e-4)

# (B, N, P, D), keep probability, kscale on the keys
CASES = {
    "query_past_tile_odd_D": ((1, 65, 17, 33), 0.7, False),
    "ragged_8key_D12": ((2, 63, 23, 12), 0.8, True),
    "D3_second_half_empty": ((1, 40, 40, 3), 0.7, True),
    "all_gated": ((2, 50, 31, 70), 0.0, True),
    "odd_D_past_the_mma_step": ((1, 70, 33, 97), 0.6, True),
}


def _inputs(seed, B, N, P, D, keep_p):
    rs = np.random.RandomState(seed)
    Q = (rs.randn(B, N, D) * D ** -0.5).astype(np.float32)
    K = rs.randn(B, P, D).astype(np.float32)
    V = rs.randn(B, P, D).astype(np.float32)
    keep = (rs.rand(B, P) < keep_p).astype(np.float32)
    dO = rs.randn(B, N, D).astype(np.float32)
    kscale = (0.5 + rs.rand(B, D)).astype(np.float32)
    return Q, K, V, keep, dO, kscale


@pytest.mark.parametrize("case", list(CASES))
def test_dkdv_reference_matches_pallas_at_ragged_shapes(case):
    """dK_eff and dV from attention_core_dkdv_reference, fed the Pallas
    forward's logsumexp and delta = rowsum(dO O), against the Pallas dK and
    dV of the same function (the keys K kscale formed before the call);
    every wrapper call on CPU tensors takes the same plain version."""
    (B, N, P, D), keep_p, scaled = CASES[case]
    Q, K, V, keep, dO, ks = _inputs(sum((B, N, P, D)), B, N, P, D, keep_p)
    K_eff = K * ks[:, None, :] if scaled else K
    jq, jk, jv, jkeep, jdo = map(jnp.asarray, (Q, K_eff, V, keep, dO))
    with pltpu.force_tpu_interpret_mode():
        out, lse = _attention_core_raw(jq, jk, jv, jkeep, return_lse=True,
                                       out_dtype=jnp.float32)
        _, want_dk, want_dv = _attention_core_bwd_pallas(
            jq, jk, jv, jkeep, out, lse, jdo, 10.0)
    t = torch.from_numpy
    out, lse = np.array(out), np.array(lse)
    args = (t(Q), t(K), t(V), t(keep), t(lse), t((dO * out).sum(-1)), t(dO),
            10.0, t(ks) if scaled else None)
    got = attention_core_dkdv_reference(*args)
    for name, g, w in zip(("dK_eff", "dV"), got, (want_dk, want_dv)):
        assert g.dtype == torch.float32 and g.shape == (B, P, D), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    if keep_p == 0.0:       # every dS multiplier is 0
        assert not got[0].any()
    for g, w in zip(attention_core_dkdv(*args), got):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
