"""The contextual-attention CUDA kernels (the default, shared-tensor and
D-split forwards, dQ, fused dK/dV, the joint backward, dV and dK) against
their plain PyTorch versions, and the kernel path's gradient against dense
autograd.

These need an NVIDIA GPU and nvcc, so they carry the ``gpu`` marker and
skip elsewhere; chip_smoke.py holds the kernel to the same plain version on
the card at the main path's shapes. Run on a GPU machine with

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu -q

Tolerances: forward float32 output rtol = atol = 1e-4 (summation order,
and split TF32 in the default and shared forwards, which keeps ~22 bits of
each product); bfloat16 output rtol = atol = 2e-2 against the plain version
fed the same bf16-rounded inputs in float32 (the output is rounded to bf16). Backward:
2e-4 of each gradient's max |value|, for both input types (float32
arithmetic and outputs on both sides, S recomputed in another order; dQ,
dV and dK in split TF32, ~22 bits of each product);
the kernel path's gradient against dense autograd: 1e-3 of its max.
"""

import numpy as np
import pytest
import torch

from sketchedit_tpu_torch.ops import attention_cuda
from sketchedit_tpu_torch.ops.attention import contextual_attention
from sketchedit_tpu_torch.ops.attention_cuda import (
    attention_core, attention_core_bwd_joint,
    attention_core_bwd_joint_reference, attention_core_dk,
    attention_core_dk_reference, attention_core_dkdv,
    attention_core_dkdv_reference, attention_core_dq,
    attention_core_dq_reference, attention_core_dsplit,
    attention_core_dsplit_reference, attention_core_dv,
    attention_core_dv_reference, attention_core_reference,
    attention_core_shared, attention_core_shared_reference, bwd_plan,
    contextual_attention_fused, dk_dv_plan, dkdv_plan, dq_plan, dsplit_cut,
    dsplit_plan, fwd_plan)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on "
                    "the card")
    return torch.device("cuda")


def _inputs(seed, B, N, P, D, keep_p, dtype, device):
    rs = np.random.RandomState(seed)
    # Q / sqrt(D) keeps the logits near 10 in spread, as in the model
    Q, K, V = (torch.from_numpy((rs.randn(B, n, D) * s).astype(np.float32)
                                ).to(device, dtype)
               for n, s in ((N, D ** -0.5), (P, 1.0), (P, 1.0)))
    keep = torch.from_numpy((rs.rand(B, P) < keep_p).astype(np.float32))
    return Q, K, V, keep.to(device)


# (input dtype, output dtype) of the forward kernels
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.float32)]
# The default and shared forwards' cases: N and P off the 64-row tiles and
# the 128-key and 96- or 192-column blocks, D off the 32-element stage (and
# not a multiple of 4, so the split rows are padded), all keys gated, D
# past the mma.sync kernel's old widest (~1750), and the main path's 256^2
# shape at B = 1 and 8.
FWD_SHAPES = [
    ((2, 130, 150, 70), 0.7),         # ragged N, P and D
    ((1, 17, 65, 33), 0.5),           # one key past a tile, odd D
    ((1, 40, 64, 1536), 0.0),         # all gated: the uniform mean of V
    ((3, 300, 200, 600), 0.9),
    ((2, 50, 70, 1537), 0.8),         # odd D
    ((1, 30, 200, 4099), 0.8),        # wide D, past the D-split's 3584
    ((1, 961, 961, 1536), 0.6),       # 256^2, B = 1
    ((8, 961, 961, 1536), 0.6),       # 256^2, B = 8
]


@pytest.mark.parametrize("dtype,out_dtype", DTYPES)
@pytest.mark.parametrize("shape,keep_p", FWD_SHAPES)
def test_kernel_matches_plain(cuda, dtype, out_dtype, shape, keep_p):
    """A separate K tensor, no kscale; the tolerance follows the output's
    dtype (the plain version is fed the same bf16-rounded inputs)."""
    Q, K, V, keep = _inputs(sum(shape), *shape, keep_p, dtype, cuda)
    before = attention_cuda.LAUNCHES
    out, lse = attention_core(Q, K, V, keep, return_lse=True,
                              out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert attention_cuda.LAUNCHES == before + 1
    want, want_lse = attention_core_reference(Q, K, V, keep, return_lse=True,
                                              out_dtype=torch.float32)
    assert out.dtype == out_dtype and out.shape == Q.shape
    torch.testing.assert_close(out.float(), want, **TOL[out_dtype])
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    if keep_p == 0.0:       # every logit 0: the uniform mean of V
        torch.testing.assert_close(
            out.float(), V.float().mean(1, keepdim=True).expand_as(out),
            **TOL[out_dtype])
    # shown with -rP: the largest differences of each case
    print("fwd", list(shape), str(dtype), str(out_dtype), "max|out - plain|",
          (out.float() - want).abs().max().item(), "max|lse - plain|",
          (lse - want_lse).abs().max().item())


@pytest.mark.parametrize("B,blocks_132", [(1, 128), (8, 1024)])
def test_fwd_plan_at_the_main_path_shapes(cuda, B, blocks_132):
    """256^2 (N = P = 961, D = 1536): one chunk of all 961 query rows; the
    logits product in blocks of 64 rows x 128 keys, P V in 128 x 96
    (float32) or 64 x 192 (bfloat16): 128 blocks each at B = 1, which covers
    a 132-SM card in one wave, 1024 at B = 8; every block within the
    shared memory a block may opt into; six launches a call. A capped
    scratch takes the query rows in 64-row multiples."""
    for dtype in (torch.float32, torch.bfloat16):
        pv = (128, 96) if dtype == torch.float32 else (64, 192)
        for shared in (False, True):
            plan = fwd_plan(B, 961, 961, 1536, dtype, shared=shared)
            print("fwd_plan", B, str(dtype), shared, plan)
            assert plan["chunks"] == 1 and plan["chunk_rows"] == 961
            assert plan["logits_blocks"] == plan["pv_blocks"] == blocks_132
            assert (plan["logits_block_rows"],
                    plan["logits_block_cols"]) == (64, 128)
            assert (plan["pv_block_rows"], plan["pv_block_cols"]) == pv
            for k in ("logits", "pv"):
                assert 0 < plan[f"{k}_smem_bytes"] <= 232448
                assert plan[f"{k}_blocks_per_sm"] >= 1
                assert plan[f"{k}_stages"] >= 3
            assert plan["launches_per_call"] == 6
            assert plan["phases"] == list(attention_cuda.FWD_PHASES)
            assert plan["scratch_bytes"] > 0
    plan = fwd_plan(2, 961, 961, 1536, cap=6 << 20)
    assert plan["chunks"] > 1 and plan["chunk_rows"] % 64 == 0
    assert plan["launches_per_call"] == 2 + 4 * plan["chunks"]


@pytest.mark.parametrize("dtype,out_dtype", DTYPES)
def test_forward_kernels_in_chunks(cuda, monkeypatch, dtype, out_dtype):
    """A scratch cap that takes the query rows in several chunks (the last
    one ragged) gives what one chunk gives, for both forwards."""
    Q, K, V, keep = _inputs(21, 2, 700, 500, 1536, 0.7, dtype, cuda)
    kscale = torch.full((2, 1536), 1536 ** -0.5, device=cuda)
    want = attention_core(V, V, V, keep, return_lse=True,
                          out_dtype=out_dtype, kscale=kscale)
    monkeypatch.setattr(attention_cuda, "SCRATCH_CAP", 4 << 20)
    plan = fwd_plan(2, 500, 500, 1536, dtype, cap=4 << 20)
    assert plan["chunks"] >= 3 and 500 % plan["chunk_rows"] != 0
    for got in (attention_core(V, V, V, keep, return_lse=True,
                               out_dtype=out_dtype, kscale=kscale),
                attention_core_shared(V, kscale, keep, return_lse=True,
                                      out_dtype=out_dtype)):
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    plain = attention_core_reference(Q, K, V, keep, out_dtype=torch.float32)
    out = attention_core(Q, K, V, keep, out_dtype=out_dtype)
    torch.testing.assert_close(out.float(), plain, **TOL[out_dtype])


@pytest.mark.parametrize("shared", [False, True], ids=["default", "shared"])
def test_forward_kernels_repeat_bit_for_bit(cuda, shared):
    """Two calls on the same inputs give the same bits: no atomics, and
    every sum (each k step's FADD, the softmax's butterfly) in a fixed
    order."""
    _, _, V, keep = _inputs(13, 8, 961, 961, 1536, 0.6, torch.float32, cuda)
    kscale = torch.full((8, 1536), 1536 ** -0.5, device=cuda)
    if shared:
        call = lambda: attention_core_shared(V, kscale, keep, return_lse=True)
    else:
        call = lambda: attention_core(V, V, V, keep, return_lse=True,
                                      kscale=kscale)
    first, second = call(), call()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_kscale_float32_out(cuda, dtype):
    """The main path's call: K = V, per-channel kscale, float32 output; held
    to the plain version on the same (bf16-rounded) inputs at float32
    tolerance, since nothing is rounded to bf16 on either side. kscale
    carries 1/sqrt(D), as the background's inverse norm does on the path,
    so the logits spread as in the model; unscaled, the logits of unit-
    variance V reach ~10^3, and two near-tied keys of a gated query differ
    between summation orders by about the tolerance."""
    Q, _, V, keep = _inputs(5, 2, 96, 96, 160, 0.8, dtype, cuda)
    kscale = ((torch.rand(2, 160, generator=torch.Generator().manual_seed(5))
               + 0.5) * 160 ** -0.5).to(cuda)
    out = attention_core(V, V, V, keep, out_dtype=torch.float32,
                         kscale=kscale)
    torch.cuda.synchronize()
    want = attention_core_reference(V.float(), V.float(), V.float(), keep,
                                    kscale=kscale)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, want, **TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,keep_p", [
    ((2, 130, 150, 70), 0.7),         # ragged; the cut at 36 of 70 columns
    ((1, 17, 65, 33), 0.5),
    ((1, 40, 64, 1536), 0.0),         # all gated, rows past N in a tile
    ((3, 300, 200, 600), 0.9),        # halves of 300 columns: warps idle
    ((9, 500, 200, 1536), 0.9),       # 32-row tiles at the model's D
    ((8, 300, 150, 1534), 0.8),       # 32-row tiles, ragged, loads by element
    ((1, 9, 9, 3), 0.9),              # D below the cut: one half is empty
    ((2, 50, 70, 1537), 0.8),         # halves past 768 columns: two slabs
    ((9, 500, 100, 1540), 0.8),       # too wide for 32 rows: 16, two slabs
])
def test_dsplit_kernel_matches_plain_and_default(cuda, dtype, shape, keep_p):
    Q, K, V, keep = _inputs(sum(shape), *shape, keep_p, dtype, cuda)
    _check_dsplit(Q, K, V, keep, dtype)


def _check_dsplit(Q, K, V, keep, dtype, default=True):
    """One D-split launch against its plain version and (where ``default``)
    the default kernel; returns its output and lse."""
    kscale = (torch.rand(Q.shape[0], Q.shape[2], generator=torch.Generator(
        ).manual_seed(3)) + 0.5).to(Q.device)
    before = attention_cuda.LAUNCHES_DSPLIT
    out, lse = attention_core_dsplit(Q, K, V, keep, return_lse=True,
                                     kscale=kscale)
    torch.cuda.synchronize()
    assert attention_cuda.LAUNCHES_DSPLIT == before + 1
    want, want_lse = attention_core_dsplit_reference(
        Q, K, V, keep, return_lse=True, kscale=kscale)
    assert out.dtype == dtype and out.shape == Q.shape
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    sib = want
    if default:
        sib, sib_lse = attention_core(Q, K, V, keep, return_lse=True,
                                      kscale=kscale)
        torch.testing.assert_close(out.float(), sib.float(), **TOL[dtype])
        torch.testing.assert_close(lse, sib_lse, rtol=1e-4, atol=1e-4)
    # shown with -rP: the largest differences of each case
    print("dsplit", list(Q.shape[:2]) + list(K.shape[1:]), str(dtype),
          "max|out - plain|", (out.float() - want.float()).abs().max().item(),
          "max|out - default|", (out.float() - sib.float()).abs().max().item(),
          "max|lse - plain|", (lse - want_lse).abs().max().item())
    return out, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile_rows,rows_per_sm_pair", [
    (32, 32),     # 32-row clusters give every SM a block
    (16, 16),     # 16-row clusters do, 32-row ones do not
    (16, 8),      # neither does (8-row ones would): still 16 rows
    (16, 0),      # a few clusters
])
def test_dsplit_kernel_ragged_at_each_tile_height(cuda, dtype, tile_rows,
                                                  rows_per_sm_pair):
    """N not a multiple of the tile, P not a multiple of 64, at the model's
    D. The launch rule takes full m16 tiles at every grid size: 32-row
    clusters where they give every SM a block, else 16-row ones. N is
    sized from the card's SM count: rows_per_sm_pair rows for every pair of
    SMs, and 5 more (77 rows when 0)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B, P, D = 1, 150, 1536
    N = sms // 2 * rows_per_sm_pair + 5 if rows_per_sm_pair else 77
    plan = dsplit_plan(B, N, P, D, dtype)
    assert (plan["tile_rows"], plan["cluster_blocks"]) == (tile_rows, 2), plan
    assert plan["max_active_clusters"] > 0, plan
    assert plan["grid_clusters"] == -(-N // tile_rows), plan
    Q, K, V, keep = _inputs(N + tile_rows, B, N, P, D, 0.8, dtype, cuda)
    _check_dsplit(Q, K, V, keep, dtype)


@pytest.mark.parametrize("dtype,widest", [(torch.float32, 3584),
                                          (torch.bfloat16, 3584)])
def test_dsplit_kernel_widest_d(cuda, dtype, widest):
    """The Q tile over half of D bounds D: the widest D whose block fits
    the card's shared memory runs and matches the plain version (the
    default and shared forwards have no such bound: FWD_SHAPES runs D =
    4099), one step wider fails with the launch's error rather than a
    wrong result."""
    B, N, P = 1, 70, 20
    for D in (widest, widest + 4):
        Q, K, V, keep = _inputs(D, B, N, P, D, 0.8, dtype, cuda)
        if D == widest:
            assert dsplit_plan(B, N, P, D, dtype)["smem_bytes"] <= 232448
            _check_dsplit(Q, K, V, keep, dtype, default=False)
        else:
            with pytest.raises(RuntimeError,
                               match="fwd_dsplit launch failed"):
                attention_core_dsplit(Q, K, V, keep)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N", [(2, 300), (9, 500)])   # 16- and 32-row tiles
def test_dsplit_kernel_halves_normalise_alike(cuda, dtype, B, N):
    """V's second half of columns is a copy of its first, so the two blocks
    of a cluster accumulate the same values with the same weights: their
    output halves are equal bit for bit only if both built the same S from
    the exchanged partials and so divide by the same running sum."""
    Q, K, V, keep = _inputs(11, B, N, 200, 1536, 0.8, dtype, cuda)
    cut = dsplit_cut(1536)
    V = torch.cat([V[..., :cut], V[..., :cut]], dim=-1).contiguous()
    out, _ = _check_dsplit(Q, K, V, keep, dtype)
    assert torch.equal(out[..., :cut], out[..., cut:])


def test_dsplit_kernel_repeats_bit_for_bit(cuda):
    """Two calls on the same inputs give the same bits: no sum depends on
    which block of a cluster gets there first."""
    Q, K, V, keep = _inputs(12, 9, 500, 200, 1536, 0.9, torch.float32, cuda)
    first = attention_core_dsplit(Q, K, V, keep, return_lse=True)
    second = attention_core_dsplit(Q, K, V, keep, return_lse=True)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_dsplit_kernel_refuses_a_gradient(cuda):
    Q, K, V, keep = _inputs(0, 1, 8, 8, 8, 1.0, torch.float32, cuda)
    with pytest.raises(RuntimeError, match="SKETCHEDIT_DSPLIT_ATTN"):
        attention_core_dsplit(Q.requires_grad_(), K, V, keep)


def _shared_plain64(V, kscale, keep):
    """The plain shared-tensor forward (attention_core_shared_reference's
    function) evaluated in float64, as float32 (out, lse). The queries are
    unscaled rows of V, so a key's similarity to itself reaches a logit of
    ~10 sqrt(D), ~400 at D = 1536, where the float32 plain version is itself
    ~1e-4 off the exact value (1.2e-4 at (8, 961, 961, 1536), the size of
    the tolerance; the CUDA-core kernel of the previous design missed it
    there too): the kernel is held to the exact value."""
    Vd = V.double()
    logits = torch.bmm(Vd, (Vd * kscale.double()[:, None, :]).transpose(1, 2))
    logits = logits * keep.double()[:, None, :] * 10.0
    out = torch.bmm(torch.softmax(logits, dim=-1), Vd)
    return out.float(), torch.logsumexp(logits, dim=-1).float()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,keep_p", [
    ((2, 150, 150, 70), 0.7),         # ragged N and D
    ((1, 65, 65, 33), 0.5),
    ((1, 64, 64, 1536), 0.0),         # all gated: the uniform mean of V
    ((3, 300, 300, 600), 0.9),
    ((9, 260, 260, 1536), 0.9),       # 16-row tiles at the model's D
    ((2, 70, 70, 1537), 0.8),         # two column slabs, odd D
    ((1, 961, 961, 1536), 0.6),       # 256^2, B = 1
    ((8, 961, 961, 1536), 0.6),       # 256^2, B = 8
])
def test_shared_kernel_matches_plain_and_default(cuda, dtype, shape, keep_p):
    B, N, _, D = shape
    _, _, V, keep = _inputs(sum(shape), *shape, keep_p, dtype, cuda)
    # 1/sqrt(D) on the keys keeps the logits spread as in the model
    kscale = ((torch.rand(B, D, generator=torch.Generator().manual_seed(4))
               + 0.5) * D ** -0.5).to(cuda)
    before = attention_cuda.LAUNCHES_SHARED, attention_cuda.LAUNCHES
    out, lse = attention_core_shared(V, kscale, keep, return_lse=True,
                                     out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert (attention_cuda.LAUNCHES_SHARED, attention_cuda.LAUNCHES) == (
        before[0] + 1, before[1])
    want, want_lse = _shared_plain64(V, kscale, keep)
    assert out.dtype == torch.float32 and out.shape == V.shape
    torch.testing.assert_close(out, want, **TOL[torch.float32])
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    sib = attention_core(V, V, V, keep, out_dtype=torch.float32,
                         kscale=kscale)
    torch.testing.assert_close(out, sib, **TOL[torch.float32])
    if dtype == torch.bfloat16:        # the bf16 output path
        out_b = attention_core_shared(V, kscale, keep)
        assert out_b.dtype == dtype
        torch.testing.assert_close(out_b.float(), want, **TOL[dtype])


SHAPES = [
    ((2, 130, 150, 70), 0.7),         # ragged N, P and D
    ((1, 17, 65, 33), 0.5),           # one key past a tile, odd D
    ((1, 40, 64, 1536), 0.0),         # all gated: dQ = dK = 0
    ((3, 300, 200, 600), 0.9),
    ((16, 140, 175, 100), 0.7),       # enough tiles for 16-row dQ and dK/dV
]
# further cases: an odd D past 1536, and the main path's 256^2 shape at
# B = 1 and 8
BWD_SHAPES = SHAPES + [
    ((2, 50, 70, 1537), 0.8),
    ((1, 961, 961, 1536), 0.6),
    ((8, 961, 961, 1536), 0.6),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,keep_p", BWD_SHAPES)
def test_bwd_kernels_match_plain(cuda, dtype, shape, keep_p):
    """Separate Q, K and V tensors (V's own split terms feed dP)."""
    Q, K, V, keep = _inputs(sum(shape) + 1, *shape, keep_p, dtype, cuda)
    rs = np.random.RandomState(sum(shape))
    B, N, _, D = shape
    dO = torch.from_numpy(rs.randn(B, N, D).astype(np.float32)).to(cuda)
    kscale = torch.from_numpy((0.5 + rs.rand(B, D)).astype(np.float32)
                              ).to(cuda)
    out, lse = attention_core(Q, K, V, keep, return_lse=True,
                              out_dtype=torch.float32, kscale=kscale)
    args = (Q, K, V, keep, lse, (dO * out).sum(-1), dO, 10.0, kscale)
    before = (attention_cuda.LAUNCHES_DQ, attention_cuda.LAUNCHES_DKDV)
    got = (attention_core_dq(*args), *attention_core_dkdv(*args))
    torch.cuda.synchronize()
    assert (attention_cuda.LAUNCHES_DQ, attention_cuda.LAUNCHES_DKDV) == (
        before[0] + 1, before[1] + 1)
    want = (attention_core_dq_reference(*args),
            *attention_core_dkdv_reference(*args))
    for name, g, w in zip(("dQ", "dK_eff", "dV"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = max(w.abs().max().item(), 1e-6)
        torch.testing.assert_close(g, w, rtol=0, atol=2e-4 * scale,
                                   msg=lambda m, n=name: f"{n}: {m}")
    if keep_p == 0.0:       # every dS multiplier is 0
        assert not got[0].any()
    # shown with -rP: the largest differences of each case
    print("bwd", list(shape), str(dtype), "max|dQ - plain| / max|dQ|",
          ((got[0] - want[0]).abs().max() / max(want[0].abs().max(), 1e-6)
           ).item())


def _main_path_bwd(seed, B, H, dtype, device):
    """The backward's arguments as the training path makes them: Q = K = V
    one tensor from ``attention_inputs`` on seeded gated-like features (H x
    H, 96 channels) with a hole in the middle, the background's inverse
    norm as kscale, a seeded float32 dO, the forward kernel's lse and
    delta."""
    rs = np.random.RandomState(seed)
    f = np.maximum(rs.randn(B, 96, H, H), 0) / (1 + np.exp(-rs.randn(
        B, 96, H, H)))
    mask = torch.zeros(B, 1, H, H)
    h = int(H * 0.4)
    mask[:, :, (H - h) // 2:(H + h) // 2, (H - h) // 2:(H + h) // 2] = 1.0
    feats = torch.from_numpy(f.astype(np.float32)).to(device, dtype)
    Q, V, keep, kscale = attention_cuda.attention_inputs(feats, feats,
                                                         mask.to(device))
    assert Q is V
    dO = torch.from_numpy(rs.randn(*Q.shape).astype(np.float32)).to(device)
    return _bwd_args(V, V, V, keep, dO, kscale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(1, 64), (8, 64), (3, 29)])
def test_dq_kernel_main_path_call(cuda, dtype, B, H):
    """The one-tensor call of the training path (one set of K terms serves
    S and dP) at 256^2 images, B = 1 and 8, and at a ragged 29^2 (N = P =
    169, D = 1536), against the plain version at 2e-4 of max |dQ|."""
    args = _main_path_bwd(B * 100 + H, B, H, dtype, cuda)
    before = attention_cuda.LAUNCHES_DQ
    got = attention_core_dq(*args)
    torch.cuda.synchronize()
    assert attention_cuda.LAUNCHES_DQ == before + 1
    want = attention_core_dq_reference(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = want.abs().max().item()
    assert scale > 0
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4 * scale)
    # shown with -rP
    print("dq main path", B, H, str(dtype), "max|dQ - plain| / max|dQ|",
          (got - want).abs().max().item() / scale)


@pytest.mark.parametrize("same", [True, False], ids=["one_tensor", "apart"])
def test_dq_kernel_repeats_bit_for_bit(cuda, same):
    """Two launches on the same inputs give the same bits: each product
    block owns its outputs, and no sum depends on which block gets there
    first."""
    args = _main_path_bwd(31, 8, 64, torch.float32, cuda)
    if not same:          # K and V apart: V's own split terms feed dP
        Q, K, V, *rest = args
        args = (Q, K.clone(), V.clone(), *rest)
    first, second = attention_core_dq(*args), attention_core_dq(*args)
    assert torch.equal(first, second)


@pytest.mark.parametrize("B,blocks_132,grad_blocks", [(1, 128, 96),
                                                      (8, 1024, 768)])
def test_dq_plan_at_the_main_path_shapes(cuda, B, blocks_132, grad_blocks):
    """256^2 training (N = P = 961, D = 1536): one chunk of all 961 query
    rows (Q kscale's and dO's terms are split once a call, outside the
    capped part, so B = 8 float32 takes one too); S (and dP) in blocks of
    64 queries x 128 keys, 128 at B = 1, which covers a 132-SM card in one
    wave, 1024 at B = 8; the dQ product in 128 x 128 in float32 and 64 x
    256 in bfloat16, 96 blocks at B = 1, 768 at B = 8; every block within
    the shared memory a block may opt into; eight launches a call; every
    product block the warp-specialised one (384 threads: a producer
    warpgroup at 40 registers a thread, two consumer warpgroups raised to
    232)."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = dq_plan(B, 961, 961, 1536, dtype)
        print("dq_plan", B, str(dtype), plan)
        dq = (128, 128) if dtype == torch.float32 else (64, 256)
        assert plan["chunks"] == 1 and plan["chunk_rows"] == 961
        assert plan["logits_blocks"] == blocks_132
        assert plan["dq_blocks"] == grad_blocks
        assert plan["weights_blocks"] == B * 961
        assert (plan["logits_block_rows"],
                plan["logits_block_cols"]) == (64, 128)
        assert (plan["dq_block_rows"], plan["dq_block_cols"]) == dq
        for k in ("logits", "dq"):
            assert 0 < plan[f"{k}_smem_bytes"] <= 232448
            assert plan[f"{k}_blocks_per_sm"] >= 1
            assert plan[f"{k}_stages"] >= 3
        assert plan["launches_per_call"] == 8
        assert (plan["threads_per_block"], plan["producer_registers"],
                plan["consumer_registers"]) == BLOCK_384
        assert plan["phases"] == list(attention_cuda.DQ_PHASES)
        assert plan["scratch_bytes"] > 0


def _check_dq(args, tag):
    """One dQ call against its plain version (2e-4 of max |dQ|); prints the
    largest difference; returns dQ."""
    before = attention_cuda.LAUNCHES_DQ
    got = attention_core_dq(*args)
    torch.cuda.synchronize()
    assert attention_cuda.LAUNCHES_DQ == before + 1
    want = attention_core_dq_reference(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = max(want.abs().max().item(), 1e-6)
    diff = (got - want).abs().max().item()
    exact = _float64_grads(args)[2]
    # shown with -rP, with each one's largest |difference| from float64
    print("dq", tag, list(args[0].shape[:2]) + list(args[1].shape[1:]),
          str(args[0].dtype), "max|dQ - plain| / max|dQ|", diff / scale,
          "max|dQ - float64|", (got.double() - exact).abs().max().item(),
          "max|plain - float64|", (want.double() - exact).abs().max().item())
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4 * scale,
                               msg=lambda m: f"{tag} dQ: {m}")
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_kernel_in_chunks(cuda, monkeypatch, dtype):
    """A scratch cap that takes the query rows in several chunks (the last
    one ragged) gives what one chunk gives, bit for bit: every S, dP and
    dS is formed alike in any chunk, and each dQ row sums its keys in the
    same order."""
    args = _bwd_case(25, 2, 700, 300, 1536, 0.8, dtype, cuda)
    B, N, D = args[0].shape
    P = args[1].shape[1]
    want = attention_core_dq(*args)
    assert dq_plan(B, N, P, D, dtype)["chunks"] == 1
    monkeypatch.setattr(attention_cuda, "SCRATCH_CAP", 1 << 20)
    plan = dq_plan(B, N, P, D, dtype, cap=1 << 20)
    print("dq chunks", str(dtype), plan["chunks"], plan["chunk_rows"])
    assert plan["chunks"] >= 3 and N % plan["chunk_rows"] != 0
    assert plan["launches_per_call"] == 4 + 4 * plan["chunks"]
    assert torch.equal(_check_dq(args, "chunks"), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,keep_p", [
    ((2, 150, 130, 70), 0.7),     # N off the 64- and 128-row blocks
    ((1, 17, 65, 33), 0.5),       # fewer queries than a block, odd D
    ((3, 300, 200, 97), 0.8),     # D off the 32-element stage and blocks
    ((2, 129, 65, 193), 0.9),     # one past a block on every side
    ((2, 481, 961, 1536), 0.6),   # the sharded path's 481-row query slice
])
def test_dq_kernel_ragged(cuda, dtype, shape, keep_p):
    """N, P and D off every tile of every phase, N apart from P: the split
    copies' rows padded to 4, the products' blocks and 32-element stages,
    the weights' rows; TMA's zeros past the maps' extents."""
    _check_dq(_bwd_case(sum(shape) + 4, *shape, keep_p, dtype, cuda),
              f"ragged{list(shape)}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_kernel_wide_d(cuda, dtype):
    """D = 4099: shared memory sets no widest D (every product streams its
    contraction in 32-element stages), and an odd D pads the split rows."""
    _check_dq(_bwd_case(4099, 1, 90, 30, 4099, 0.8, dtype, cuda), "D4099")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_where_ds_cancels_within_split_tf32(cuda, dtype):
    """(N, P, D) = (2, 3, 1), every key kept: dS = P (dP - delta) g cancels
    with one dominant key, so dQ sits ~9e-4 of max |dQ| from the plain
    float32 version, past the 2e-4 the other shapes meet. Against float64
    both dQ routes (dQ's sequence and the joint's) stay within one unit of
    split TF32's accuracy: 2^-22 times what S, dP, delta and lse carried
    to that accuracy, and dS and K_eff in the product, can move each
    element by (chip_smoke.py's dq_rows, which holds the main path's rows
    to the same unit)."""
    from chip_smoke import dq_rows
    args = _bwd_case(11, 1, 2, 3, 1, 1.0, dtype, cuda)
    for dq in (attention_core_dq(*args), attention_core_bwd_joint(*args)[0]):
        units = dq_rows(args, dq)["tf32_units"].max().item()
        print("dq split tf32 units", str(dtype), units)
        assert units <= 1.0, units


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_kernel_all_keys_gated(cuda, dtype):
    """Every key gated: the dS multiplier is 0, so dQ is exactly 0."""
    args = _bwd_case(23, 9, 130, 500, 1536, 0.0, dtype, cuda)
    assert not args[3].any()
    assert not _check_dq(args, "all_gated").any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_kernel_v_apart_from_k(cuda, dtype):
    """K and V apart on the main path's inputs (V's own split terms feed
    dP): the same values in the same order as the one-tensor call, whose
    one set of K terms serves S and dP, so the same bits, and within
    tolerance of the plain version."""
    args = _main_path_bwd(34, 8, 64, dtype, cuda)
    Q, K, V, *rest = args
    got = _check_dq((Q, K.clone(), V.clone(), *rest), "v_apart")
    assert torch.equal(got, attention_core_dq(*args))


def _bwd_args(Q, K, V, keep, dO, kscale):
    """The backward kernels' arguments: the forward kernel's lse and
    delta = rowsum(dO O) for these inputs."""
    out, lse = attention_core(Q, K, V, keep, return_lse=True,
                              out_dtype=torch.float32, kscale=kscale)
    return (Q, K, V, keep, lse, (dO * out).sum(-1), dO, 10.0, kscale)


def _check_dkdv(args, tag):
    """One fused dK/dV launch against its plain version (2e-4 of each
    gradient's max); prints the largest differences; returns (dK_eff,
    dV)."""
    before = attention_cuda.LAUNCHES_DKDV
    got = attention_core_dkdv(*args)
    torch.cuda.synchronize()
    assert attention_cuda.LAUNCHES_DKDV == before + 1
    want = attention_core_dkdv_reference(*args)
    diffs = []
    for name, g, w in zip(("dK_eff", "dV"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = max(w.abs().max().item(), 1e-6)
        diffs.append((g - w).abs().max().item())
        torch.testing.assert_close(g, w, rtol=0, atol=2e-4 * scale,
                                   msg=lambda m, n=name: f"{tag} {n}: {m}")
    # shown with -rP: the largest differences of each case
    print("dkdv", tag, list(args[0].shape[:2]) + list(args[1].shape[1:]),
          str(args[0].dtype), "max|dK_eff - plain|", diffs[0],
          "max|dV - plain|", diffs[1])
    return got


# every backward product's block: threads, and the registers a thread that
# its producer warpgroup and its consumers set
BLOCK_384 = (384, 40, 232)


def _bwd_case(seed, B, N, P, D, keep_p, dtype, device):
    Q, K, V, keep = _inputs(seed, B, N, P, D, keep_p, dtype, device)
    rs = np.random.RandomState(seed + 7)
    dO = torch.from_numpy(rs.randn(B, N, D).astype(np.float32)).to(device)
    kscale = torch.from_numpy((0.5 + rs.rand(B, D)).astype(np.float32)
                              ).to(device)
    return _bwd_args(Q, K, V, keep, dO, kscale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dkdv_kernel_in_chunks(cuda, monkeypatch, dtype):
    """A scratch cap that takes the keys in several chunks (the last one
    ragged) gives what one chunk gives, bit for bit: every S, dP and
    weight is formed alike in any chunk, and each output row sums its
    queries in the same order."""
    args = _bwd_case(24, 2, 300, 700, 1536, 0.8, dtype, cuda)
    B, N, D = args[0].shape
    P = args[1].shape[1]
    want = attention_core_dkdv(*args)
    assert dkdv_plan(B, N, P, D, dtype)["chunks"] == 1
    monkeypatch.setattr(attention_cuda, "SCRATCH_CAP", 2 << 20)
    plan = dkdv_plan(B, N, P, D, dtype, cap=2 << 20)
    print("dkdv chunks", str(dtype), plan["chunks"], plan["chunk_rows"])
    assert plan["chunks"] >= 3 and P % plan["chunk_rows"] != 0
    assert plan["launches_per_call"] == 5 + 5 * plan["chunks"]
    got = _check_dkdv(args, "chunks")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,keep_p", [
    ((2, 130, 150, 70), 0.7),     # N off the 64-row and 32-query tiles
    ((1, 17, 65, 33), 0.5),       # fewer queries than a stage, odd D
    ((3, 200, 300, 97), 0.8),     # P off the 128-key and 128-row blocks
    ((2, 65, 129, 190), 0.9),     # one past a block on every side
    ((1, 2, 3, 1), 1.0),          # two queries, three keys, one column
])
def test_dkdv_kernel_ragged(cuda, dtype, shape, keep_p):
    """N, P and D off every tile of every phase: the split copies' rows
    padded to 4, the products' blocks and 32-element stages, the weights'
    32 x 32 tiles; TMA's zeros past the maps' extents."""
    _check_dkdv(_bwd_case(sum(shape) + 3, *shape, keep_p, dtype, cuda),
                f"ragged{list(shape)}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dkdv_kernel_wide_d(cuda, dtype):
    """D = 4099: shared memory sets no widest D (every product streams its
    contraction in 32-element stages), and an odd D pads the split rows."""
    _check_dkdv(_bwd_case(4099, 1, 30, 90, 4099, 0.8, dtype, cuda), "D4099")


@pytest.mark.parametrize("B,blocks_132,grad_blocks", [(1, 128, 96),
                                                      (8, 1024, 768)])
def test_dkdv_plan_at_the_main_path_shapes(cuda, B, blocks_132,
                                           grad_blocks):
    """256^2 training (N = P = 961, D = 1536): one chunk of all 961 keys;
    S (and dP) in blocks of 64 queries x 128 keys, 128 at B = 1, which
    covers a 132-SM card in one wave, 1024 at B = 8; dV in 128 keys x 128
    columns, dK the same in float32 and 64 x 256 in bfloat16, 96 blocks at
    B = 1, 768 at B = 8; every block within the shared memory a block may
    opt into; ten launches a call; the warp-specialised product block."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = dkdv_plan(B, 961, 961, 1536, dtype)
        print("dkdv_plan", B, str(dtype), plan)
        dk = (128, 128) if dtype == torch.float32 else (64, 256)
        assert plan["chunks"] == 1 and plan["chunk_rows"] == 961
        assert plan["logits_blocks"] == blocks_132
        assert plan["dv_blocks"] == plan["dk_blocks"] == grad_blocks
        assert (plan["logits_block_rows"],
                plan["logits_block_cols"]) == (64, 128)
        assert (plan["dv_block_rows"], plan["dv_block_cols"]) == (128, 128)
        assert (plan["dk_block_rows"], plan["dk_block_cols"]) == dk
        for k in ("logits", "dv", "dk"):
            assert 0 < plan[f"{k}_smem_bytes"] <= 232448
            assert plan[f"{k}_blocks_per_sm"] >= 1
            assert plan[f"{k}_stages"] >= 3
        assert plan["launches_per_call"] == 10
        assert (plan["threads_per_block"], plan["producer_registers"],
                plan["consumer_registers"]) == BLOCK_384
        assert plan["phases"] == list(attention_cuda.DKDV_PHASES)
        assert plan["scratch_bytes"] > 0


def test_dkdv_kernel_repeats_bit_for_bit(cuda):
    """Two calls on the same inputs give the same bits: each product block
    owns its outputs, and no sum depends on which block gets there first."""
    args = _bwd_case(22, 9, 130, 500, 1536, 0.9, torch.float32, cuda)
    first = attention_core_dkdv(*args)
    second = attention_core_dkdv(*args)
    print("dkdv repeat max|first - second|",
          [(a - b).abs().max().item() for a, b in zip(first, second)])
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dkdv_kernel_all_keys_gated(cuda, dtype):
    """Every key gated: logits 0, so P is uniform and dV the column sums of
    dO over P; the dS multiplier is 0, so dK_eff is 0."""
    args = _bwd_case(23, 9, 130, 500, 1536, 0.0, dtype, cuda)
    assert not args[3].any()
    dK, _ = _check_dkdv(args, "all_gated")
    assert not dK.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dkdv_kernel_v_apart_from_k(cuda, dtype):
    """K and V apart on the main path's inputs (V's own split terms feed
    dP): the same values in the same order as the one-tensor call, whose
    one set of K terms serves S and dP, so the same bits, and within
    tolerance of the plain version."""
    args = _main_path_bwd(33, 8, 64, dtype, cuda)
    Q, K, V, *rest = args
    apart = (Q, K.clone(), V.clone(), *rest)
    got = _check_dkdv(apart, "v_apart")
    one = attention_core_dkdv(*args)
    print("dkdv v_apart max|apart - one tensor|",
          [(a - b).abs().max().item() for a, b in zip(got, one)])
    assert all(torch.equal(a, b) for a, b in zip(got, one))


def _float64_grads(args):
    """dK_eff, dV and dQ evaluated in float64 from the same inputs (the
    forward kernel's lse and delta)."""
    Q, K, V, keep, lse, delta, dO, scale, ks = (
        t.double() if torch.is_tensor(t) else t for t in args)
    g = keep[:, None, :] * scale
    Keff = K * ks[:, None, :]
    P = torch.exp(torch.bmm(Q, Keff.transpose(1, 2)) * g - lse[..., None])
    dS = P * (torch.bmm(dO, V.transpose(1, 2)) - delta[..., None]) * g
    return (torch.bmm(dS.transpose(1, 2), Q), torch.bmm(P.transpose(1, 2), dO),
            torch.bmm(dS, Keff))


# The largest |difference| from float64 as a share of the largest value of
# dK_eff and dV from the mma.sync dK and dV kernels that the masked
# sequences replaced, at each case's inputs (this test's readings of them
# on an H100 80GB HBM3 at 700 W; PERF.md, Findings)
DK_DV_F64_BEFORE = {
    (1, 64, torch.float32): {"dK_eff": 2.832e-06, "dV": 1.242e-05},
    (1, 64, torch.bfloat16): {"dK_eff": 1.859e-06, "dV": 1.664e-05},
    (3, 29, torch.float32): {"dK_eff": 4.750e-06, "dV": 2.410e-05},
    (3, 29, torch.bfloat16): {"dK_eff": 3.807e-06, "dV": 2.821e-05}}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(1, 64), (3, 29)])
def test_dkdv_kernel_as_close_to_float64_as_dk_dv(cuda, dtype, B, H):
    """At the main path's one-tensor call, the fused dK/dV's and dV's and
    dK's alone (one sequence, masked) dK_eff and dV lie no further from a
    float64 evaluation of the same function than twice the mma.sync dK and
    dV kernels did (DK_DV_F64_BEFORE), each as a share of the largest
    value."""
    args = _main_path_bwd(B * 100 + H + 5, B, H, dtype, cuda)
    Q, K, _, keep, lse, _, dO, _, ks = args
    want = _float64_grads(args)[:2]
    fused = attention_core_dkdv(*args)
    alone = (attention_core_dk(*args),
             attention_core_dv(Q, K, keep, lse, dO, 10.0, ks))
    dist = lambda a, w: ((a.double() - w).abs().max() / w.abs().max()).item()
    for name, f, a, w in zip(("dK_eff", "dV"), fused, alone, want):
        d_fused, d_alone = dist(f, w), dist(a, w)
        before = DK_DV_F64_BEFORE[(B, H, dtype)][name]
        print("dkdv float64", B, H, str(dtype), name, "fused", d_fused,
              "alone", d_alone, "before", before)
        assert d_fused <= 2 * before, (name, d_fused, before)
        assert d_alone <= 2 * before, (name, d_alone, before)


# dQ's relative L2 from float64 over the fused dK/dV's dK_eff's at each
# case's inputs with the mma.sync dQ kernel that the wgmma sequence
# replaced (scripts/dq_variants.py --seeds, PERF.md PR 18)
DQ_F64_BEFORE = {(1, 64, torch.float32): 1.190, (1, 64, torch.bfloat16): 1.205,
                 (3, 29, torch.float32): 1.192, (3, 29, torch.bfloat16): 2.045}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(1, 64), (3, 29)])
def test_dq_kernel_as_close_to_float64_as_before(cuda, dtype, B, H):
    """At test_dkdv_kernel_as_close_to_float64_as_dk_dv's inputs, dQ's
    relative L2 from a float64 evaluation, over the fused dK/dV's dK_eff's,
    stays within 1.5x of that ratio with the mma.sync dQ kernel."""
    args = _main_path_bwd(B * 100 + H + 5, B, H, dtype, cuda)
    want_dk, _, want_dq = _float64_grads(args)
    l2 = lambda a, w: ((a.double() - w).norm() / w.norm()).item()
    d_dq = l2(attention_core_dq(*args), want_dq)
    d_dk = l2(attention_core_dkdv(*args)[0], want_dk)
    before = DQ_F64_BEFORE[(B, H, dtype)]
    print("dq float64", B, H, str(dtype), "dQ", d_dq, "dK_eff", d_dk,
          "ratio", d_dq / d_dk, "before", before)
    assert d_dq / d_dk <= 1.5 * before, (d_dq, d_dk, before)


def _check_joint(args, tag, parent=True):
    """One joint backward call: one LAUNCHES_BWD count and no dQ or dK/dV
    one; against the plain version (2e-4 of each gradient's max); where
    ``parent``, against the dQ and fused dK/dV sequences on the same
    inputs, bit for bit (one chunk: the same S, dP and dS bits, each
    product in the same order). Returns (dQ, dK_eff, dV)."""
    names = ("LAUNCHES_BWD", "LAUNCHES_DQ", "LAUNCHES_DKDV")
    before = [getattr(attention_cuda, n) for n in names]
    got = attention_core_bwd_joint(*args)
    torch.cuda.synchronize()
    assert [getattr(attention_cuda, n) - b
            for n, b in zip(names, before)] == [1, 0, 0]
    want = attention_core_bwd_joint_reference(*args)
    diffs = []
    for name, g, w in zip(("dQ", "dK_eff", "dV"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = max(w.abs().max().item(), 1e-6)
        diffs.append((g - w).abs().max().item() / scale)
        torch.testing.assert_close(g, w, rtol=0, atol=2e-4 * scale,
                                   msg=lambda m, n=name: f"{tag} {n}: {m}")
    # shown with -rP
    print("bwd", tag, list(args[0].shape[:2]) + list(args[1].shape[1:]),
          str(args[0].dtype), "max|. - plain| / max|.| (dQ, dK_eff, dV)",
          diffs)
    if parent:
        two = (attention_core_dq(*args), *attention_core_dkdv(*args))
        print("bwd", tag, "max|joint - dq, dkdv|",
              [(a - b).abs().max().item() for a, b in zip(got, two)])
        for name, a, b in zip(("dQ", "dK_eff", "dV"), got, two):
            assert torch.equal(a, b), (tag, name)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    ("main", 1, 64), ("main", 8, 64),      # 256^2 training, one tensor
    ((2, 150, 130, 70), 0.7), ((1, 17, 65, 33), 0.5), ((3, 300, 200, 97), 0.8),
    ((2, 129, 65, 193), 0.9), ((2, 481, 961, 1536), 0.6),
], ids=["main_B1", "main_B8", "150x130x70", "17x65x33", "300x200x97",
        "129x65x193", "qslice481"])
def test_bwd_joint_equals_dq_and_dkdv(cuda, dtype, shape):
    """At one chunk the joint backward gives the dQ sequence's dQ and the
    fused dK/dV's dK_eff and dV bit for bit: the main path's one-tensor
    call at 256^2 (B = 1 and 8) and test_dq_kernel_ragged's shapes."""
    if shape[0] == "main":
        args = _main_path_bwd(shape[1] * 100 + shape[2] + 9, *shape[1:],
                              dtype, cuda)
    else:
        args = _bwd_case(sum(shape[0]) + 9, *shape[0], shape[1], dtype, cuda)
    B, N, D = args[0].shape
    assert bwd_plan(B, N, args[1].shape[1], D, dtype)["chunks"] == 1
    _check_joint(args, f"{shape}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_joint_in_chunks(cuda, monkeypatch, dtype):
    """A scratch cap that takes the keys in several chunks (the last one
    ragged): dK_eff and dV are one chunk's bit for bit (each key row's
    products sum the queries alike in any chunk); dQ adds the chunks' parts
    in order, within 2e-4 of max |dQ| of the plain version."""
    args = _bwd_case(26, 2, 300, 700, 1536, 0.8, dtype, cuda)
    B, N, D = args[0].shape
    P = args[1].shape[1]
    one = attention_core_bwd_joint(*args)
    monkeypatch.setattr(attention_cuda, "SCRATCH_CAP", 2 << 20)
    plan = bwd_plan(B, N, P, D, dtype, cap=2 << 20)
    print("bwd chunks", str(dtype), plan["chunks"], plan["chunk_rows"])
    assert plan["chunks"] >= 3 and P % plan["chunk_rows"] != 0
    assert plan["launches_per_call"] == 6 + 6 * plan["chunks"]
    got = _check_joint(args, "chunks", parent=False)
    assert torch.equal(got[1], one[1]) and torch.equal(got[2], one[2])
    print("bwd chunks max|dQ - one chunk| / max|dQ|",
          ((got[0] - one[0]).abs().max() / one[0].abs().max()).item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_joint_v_apart_from_k(cuda, dtype):
    """K and V apart on the main path's inputs (V's own split terms feed
    dP): the bits of the one-tensor call, and of the two sequences."""
    args = _main_path_bwd(35, 8, 64, dtype, cuda)
    Q, K, V, *rest = args
    got = _check_joint((Q, K.clone(), V.clone(), *rest), "v_apart")
    one = attention_core_bwd_joint(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, one))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_joint_all_keys_gated(cuda, dtype):
    """Every key gated: the dS multiplier is 0, so dQ and dK_eff are
    exactly 0; dV the column sums of dO over the uniform P."""
    args = _bwd_case(27, 9, 130, 500, 1536, 0.0, dtype, cuda)
    assert not args[3].any()
    dQ, dK, _ = _check_joint(args, "all_gated")
    assert not dQ.any() and not dK.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_joint_wide_d(cuda, dtype):
    """D = 4099: no widest D, an odd D pads the split rows."""
    _check_joint(_bwd_case(4100, 1, 90, 30, 4099, 0.8, dtype, cuda), "D4099")


def test_bwd_joint_repeats_bit_for_bit(cuda):
    """Two calls on the same inputs give the same bits, in one chunk and in
    several (dQ's later chunks add to its earlier ones in launch order)."""
    args = _bwd_case(28, 9, 130, 500, 1536, 0.9, torch.float32, cuda)
    for cap in (attention_cuda.SCRATCH_CAP, 1 << 20):
        saved, attention_cuda.SCRATCH_CAP = attention_cuda.SCRATCH_CAP, cap
        try:
            first = attention_core_bwd_joint(*args)
            second = attention_core_bwd_joint(*args)
        finally:
            attention_cuda.SCRATCH_CAP = saved
        assert all(torch.equal(a, b) for a, b in zip(first, second)), cap


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(1, 64), (3, 29)])
def test_bwd_joint_as_close_to_float64(cuda, dtype, B, H):
    """At test_dkdv_kernel_as_close_to_float64_as_dk_dv's inputs: the joint
    dK_eff and dV within twice the dK and dV kernels' largest |difference|
    from float64 (each a share of the largest value), and dQ's relative L2
    over dK_eff's within 1.5x of the mma.sync dQ kernel's ratio (the bars
    of that test and test_dq_kernel_as_close_to_float64_as_before)."""
    args = _main_path_bwd(B * 100 + H + 5, B, H, dtype, cuda)
    Q, K, _, keep, lse, _, dO, _, ks = args
    want_dk, want_dv, want_dq = _float64_grads(args)
    dQ, dK, dV = attention_core_bwd_joint(*args)
    alone = (attention_core_dk(*args),
             attention_core_dv(Q, K, keep, lse, dO, 10.0, ks))
    dist = lambda a, w: ((a.double() - w).abs().max() / w.abs().max()).item()
    for name, f, a, w in zip(("dK_eff", "dV"), (dK, dV), alone,
                             (want_dk, want_dv)):
        print("bwd float64", B, H, str(dtype), name, "joint", dist(f, w),
              "alone", dist(a, w))
        assert dist(f, w) <= 2 * dist(a, w), name
    l2 = lambda a, w: ((a.double() - w).norm() / w.norm()).item()
    ratio = l2(dQ, want_dq) / l2(dK, want_dk)
    print("bwd float64", B, H, str(dtype), "dQ over dK_eff", ratio)
    assert ratio <= 1.5 * DQ_F64_BEFORE[(B, H, dtype)], ratio


@pytest.mark.parametrize("B,blocks_132,grad_blocks", [(1, 128, 96),
                                                      (8, 1024, 768)])
def test_bwd_plan_at_the_main_path_shapes(cuda, B, blocks_132, grad_blocks):
    """256^2 training (N = P = 961, D = 1536): one chunk of all 961 keys
    up to B = 8 (dS's terms by rows counted in the cap: 237 MB of 256 MiB
    at B = 8), the fused dK/dV's blocks, dQ in 128 x 128 (64 x 256 in
    bfloat16): S and dP 128 blocks at B = 1, 1024 at B = 8, dV, dK and dQ
    96 and 768; twelve launches a call; the warp-specialised product
    block."""
    for dtype in (torch.float32, torch.bfloat16):
        plan = bwd_plan(B, 961, 961, 1536, dtype)
        print("bwd_plan", B, str(dtype), plan)
        dq = (128, 128) if dtype == torch.float32 else (64, 256)
        assert plan["chunks"] == 1 and plan["chunk_rows"] == 961
        assert plan["logits_blocks"] == blocks_132
        assert (plan["dv_blocks"] == plan["dk_blocks"] == plan["dq_blocks"]
                == grad_blocks)
        assert (plan["dq_block_rows"], plan["dq_block_cols"]) == dq
        for k in ("logits", "dv", "dk", "dq"):
            assert 0 < plan[f"{k}_smem_bytes"] <= 232448
            assert plan[f"{k}_blocks_per_sm"] >= 1
            assert plan[f"{k}_stages"] >= 3
        assert plan["launches_per_call"] == 12
        assert (plan["threads_per_block"], plan["producer_registers"],
                plan["consumer_registers"]) == BLOCK_384
        assert plan["phases"] == list(attention_cuda.BWD_PHASES)
        assert plan["scratch_bytes"] > attention_cuda.dkdv_scratch(
            B, 961, 961, 1536, dtype)[0]


def test_launches_run_on_the_tensors_device(cuda):
    """Tensors on the second card, the first card current: every forward
    and backward kernel launches on the tensors' card and matches its plain
    version there, and the first card is current again after each call."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    dev = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    args = _bwd_case(24, 2, 130, 150, 70, 0.8, torch.float32, dev)
    Q, K, V, keep, lse, delta, dO, _, ks = args
    tol = TOL[torch.float32]
    for got, want in (
            (attention_core(Q, K, V, keep, kscale=ks),
             attention_core_reference(Q, K, V, keep, kscale=ks)),
            (attention_core_dsplit(Q, K, V, keep, kscale=ks),
             attention_core_dsplit_reference(Q, K, V, keep, kscale=ks)),
            (attention_core_shared(V, ks, keep),
             attention_core_shared_reference(V, ks, keep))):
        torch.cuda.synchronize(dev)
        assert got.device == dev and torch.cuda.current_device() == 0
        torch.testing.assert_close(got, want, **tol)
    for got, want in (
            (attention_core_dq(*args), attention_core_dq_reference(*args)),
            (attention_core_dkdv(*args)[0],
             attention_core_dkdv_reference(*args)[0]),
            (attention_core_dv(Q, K, keep, lse, dO, 10.0, ks),
             attention_core_dv_reference(Q, K, keep, lse, dO, 10.0, ks)),
            (attention_core_dk(*args), attention_core_dk_reference(*args)),
            (attention_core_bwd_joint(*args)[0],
             attention_core_bwd_joint_reference(*args)[0])):
        torch.cuda.synchronize(dev)
        assert got.device == dev and torch.cuda.current_device() == 0
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2e-4 * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,keep_p", SHAPES + [
    ((9, 130, 500, 1536), 0.8),       # the model's D
    ((2, 50, 70, 1537), 0.8),         # an odd D past 1536
    ((1, 150, 77, 1536), 0.8),        # P off the 128-key blocks
    ((2, 50, 70, 1544), 0.8),
    ((1, 30, 90, 4099), 0.8),         # no widest D
    # the training path's one-tensor call (Q = K = V from attention_inputs)
    # at 256^2, B = 1 and 8, and a ragged 29^2
    (("main", 1, 64), None),
    (("main", 8, 64), None),
    (("main", 3, 29), None),
])
def test_dv_dk_kernels_match_plain_and_fused(cuda, dtype, shape, keep_p):
    """dV and dK_eff alone (the backward sequence with a mask of one
    product) against their plain versions (2e-4 of each gradient's max),
    and bit for bit against the joint backward's and the fused dK/dV's,
    whose S, dP, weights and products they share; all keys gated: dK_eff
    is exactly 0. The plain versions run on CPU copies, as the port runs
    them: on the main path the logits reach the hundreds (244 at the
    ragged 29^2), where the plain dV on the card lies 1.5e-4 to 1.7e-4 of
    its max from a float64 evaluation of the same function, the kernels
    under 4e-5 and the plain dV on the CPU under 5e-5
    (scripts/dk_dv_variants.py --precision)."""
    if shape[0] == "main":
        args = _main_path_bwd(shape[1] * 100 + shape[2] + 1, *shape[1:],
                              dtype, cuda)
        assert args[0] is args[1] and args[1] is args[2]
    else:
        Q, K, V, keep = _inputs(sum(shape) + 2, *shape, keep_p, dtype, cuda)
        rs = np.random.RandomState(sum(shape))
        B, N, _, D = shape
        dO = torch.from_numpy(rs.randn(B, N, D).astype(np.float32)).to(cuda)
        kscale = torch.from_numpy((0.5 + rs.rand(B, D)).astype(np.float32)
                                  ).to(cuda)
        args = _bwd_args(Q, K, V, keep, dO, kscale)
    Q, K, _, keep, lse, _, dO, _, kscale = args
    before = (attention_cuda.LAUNCHES_DV, attention_cuda.LAUNCHES_DK)
    dV = attention_core_dv(Q, K, keep, lse, dO, 10.0, kscale)
    dK = attention_core_dk(*args)
    torch.cuda.synchronize()
    assert (attention_cuda.LAUNCHES_DV, attention_cuda.LAUNCHES_DK) == (
        before[0] + 1, before[1] + 1)
    fused = attention_core_dkdv(*args)
    joint = attention_core_bwd_joint(*args)
    cpu = [t.cpu() if torch.is_tensor(t) else t for t in args]
    Qc, Kc, _, keep_c, lse_c, _, dO_c, _, kscale_c = cpu
    diffs = []
    for name, g, w, sibs in (
            ("dV", dV, attention_core_dv_reference(
                Qc, Kc, keep_c, lse_c, dO_c, 10.0, kscale_c).to(cuda),
             (fused[1], joint[2])),
            ("dK_eff", dK, attention_core_dk_reference(*cpu).to(cuda),
             (fused[0], joint[1]))):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = max(w.abs().max().item(), 1e-6)
        diffs.append((g - w).abs().max().item() / scale)
        torch.testing.assert_close(g, w, rtol=0, atol=2e-4 * scale,
                                   msg=lambda m, n=name: f"{n}: {m}")
        for sib in sibs:
            assert torch.equal(g, sib), (name, (g - sib).abs().max().item())
    if keep_p == 0.0:       # every dS multiplier is 0
        assert not dK.any()
    # shown with -rP: the largest differences of each case
    print("dv dk", shape, str(dtype), "max|dV - plain| / max|dV|", diffs[0],
          "max|dK_eff - plain| / max|dK_eff|", diffs[1])


@pytest.mark.parametrize("same", [True, False], ids=["one_tensor", "apart"])
def test_dk_dv_repeat_bit_for_bit(cuda, same):
    """Two calls on the same inputs give the same bits, with K and V one
    tensor and apart (dK's prep then splits V's rows for dP): each product
    block owns its outputs, and no sum depends on which block gets there
    first."""
    args = _main_path_bwd(32, 8, 64, torch.float32, cuda)
    if not same:          # K and V apart: V's own split terms feed dP
        Q, K, V, *rest = args
        args = (Q, K.clone(), V.clone(), *rest)
    Q, K, _, keep, lse, _, dO, _, kscale = args
    dv = lambda: attention_core_dv(Q, K, keep, lse, dO, 10.0, kscale)
    assert torch.equal(dv(), dv())
    assert torch.equal(attention_core_dk(*args), attention_core_dk(*args))


@pytest.mark.parametrize("B,blocks_132,grad_blocks", [(1, 128, 96),
                                                      (8, 1024, 768)])
def test_dk_dv_plan_at_the_main_path_shapes(cuda, B, blocks_132,
                                            grad_blocks):
    """256^2 training (N = P = 961, D = 1536): dV and dK alone each take
    one chunk of all 961 keys, the fused dK/dV's S blocks (128 at B = 1,
    1024 at B = 8) and their own product's (96 and 768), every block
    within the shared memory a block may opt into; dV alone 3 + 3 launches
    (K, Q kscale and dO transposed; S, the weights, dV), dK alone 4 + 4 (K, Q
    kscale, dO, Q transposed; S, dP, the weights, dK), each on less scratch
    than the fused dK/dV; no product of the other's in the plan; the
    warp-specialised product block; and D = 4099 in one chunk too."""
    for dtype in (torch.float32, torch.bfloat16):
        fused = dkdv_plan(B, 961, 961, 1536, dtype)
        for dk, own, other, launches in ((False, "dv", "dk", 6),
                                         (True, "dk", "dv", 8)):
            plan = dk_dv_plan(B, 961, 961, 1536, dtype, dk=dk)
            print("dk_dv_plan", B, str(dtype), own, plan)
            assert plan["chunks"] == 1 and plan["chunk_rows"] == 961
            assert plan["logits_blocks"] == blocks_132
            assert plan[f"{own}_blocks"] == grad_blocks
            for k in ("logits", own):
                assert 0 < plan[f"{k}_smem_bytes"] <= 232448
                assert plan[f"{k}_blocks_per_sm"] >= 1
                for key in ("smem_bytes", "stages", "block_rows",
                            "block_cols"):
                    assert plan[f"{k}_{key}"] == fused[f"{k}_{key}"]
            assert not any(k.startswith((other, "dq")) for k in plan), plan
            assert plan["launches_per_call"] == launches
            assert (plan["threads_per_block"], plan["producer_registers"],
                    plan["consumer_registers"]) == BLOCK_384
            assert plan["phases"] == list(attention_cuda.grad_phases(
                attention_cuda.GRAD_DK if dk else attention_cuda.GRAD_DV))
            assert 0 < plan["scratch_bytes"] < fused["scratch_bytes"]
    for dk in (False, True):
        assert dk_dv_plan(2, 50, 70, 4099, dk=dk)["chunks"] == 1


@pytest.mark.parametrize("switch", ["SKETCHEDIT_SHARED_ATTN",
                                    "SKETCHEDIT_SPLIT_DKDV"])
def test_switched_gradient_matches_default(cuda, monkeypatch, switch):
    """contextual_attention_fused under each differentiable switch: the
    kernels it names are the ones launched, and output and gradient equal
    the default kernels' (1e-4; 2e-4 of the gradient's max)."""
    rs = np.random.RandomState(2)
    f = torch.from_numpy(np.maximum(rs.randn(2, 96, 32, 32), 0).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy((rs.rand(2, 1, 32, 32) > 0.5).astype(np.float32)
                            ).to(cuda)

    def run():
        x = f.clone().requires_grad_()
        out = contextual_attention_fused(x, x, mask)
        return out.detach(), torch.autograd.grad((out ** 2).sum(), x)[0]

    want = run()
    names = ("LAUNCHES", "LAUNCHES_SHARED", "LAUNCHES_DQ", "LAUNCHES_DKDV",
             "LAUNCHES_BWD", "LAUNCHES_DV", "LAUNCHES_DK")
    before = [getattr(attention_cuda, n) for n in names]
    monkeypatch.setenv(switch, "1")
    got = run()
    used = [getattr(attention_cuda, n) - b for n, b in zip(names, before)]
    assert used == {"SKETCHEDIT_SHARED_ATTN": [0, 1, 0, 0, 1, 0, 0],
                    "SKETCHEDIT_SPLIT_DKDV": [1, 0, 1, 0, 0, 1, 1]}[switch], used
    torch.testing.assert_close(got[0], want[0], **TOL[torch.float32])
    torch.testing.assert_close(got[1], want[1], rtol=0,
                               atol=2e-4 * want[1].abs().max().item())
    if switch == "SKETCHEDIT_SPLIT_DKDV":
        # dQ in one chunk of queries, dV and dK alone: the joint's bits
        assert torch.equal(got[1], want[1])


def test_dsplit_switch_takes_the_dsplit_kernel(cuda, monkeypatch):
    rs = np.random.RandomState(3)
    f = torch.from_numpy(rs.randn(2, 96, 32, 32).astype(np.float32)).to(cuda)
    mask = torch.from_numpy((rs.rand(2, 1, 32, 32) > 0.5).astype(np.float32)
                            ).to(cuda)
    want = contextual_attention_fused(f, f, mask)
    monkeypatch.setenv("SKETCHEDIT_DSPLIT_ATTN", "1")
    before = attention_cuda.LAUNCHES_DSPLIT, attention_cuda.LAUNCHES
    got = contextual_attention_fused(f, f, mask)
    assert (attention_cuda.LAUNCHES_DSPLIT, attention_cuda.LAUNCHES) == (
        before[0] + 1, before[1])
    torch.testing.assert_close(got, want, **TOL[torch.float32])
    with pytest.raises(RuntimeError, match="SKETCHEDIT_DSPLIT_ATTN"):
        contextual_attention_fused(f.requires_grad_(), f, mask)


def test_fused_gradient_matches_dense_autograd(cuda):
    """The kernel path's autograd (ContextualAttentionCore: forward with
    lse, one joint backward launch) against dense autograd."""
    rs = np.random.RandomState(1)
    f = torch.from_numpy(np.maximum(rs.randn(2, 96, 32, 32), 0).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy((rs.rand(2, 1, 32, 32) > 0.5).astype(np.float32)
                            ).to(cuda)
    grads = []
    for fn in (contextual_attention_fused, contextual_attention):
        x = f.clone().requires_grad_()
        before = (attention_cuda.LAUNCHES_LSE, attention_cuda.LAUNCHES_BWD)
        out = fn(x, x, mask)
        assert out.grad_fn is not None
        grads.append(torch.autograd.grad((out ** 2).sum(), x)[0])
        after = (attention_cuda.LAUNCHES_LSE, attention_cuda.LAUNCHES_BWD)
        want = 1 if fn is contextual_attention_fused else 0
        assert after == tuple(b + want for b in before)
    scale = grads[1].abs().max().item()
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=1e-3 * scale)


def test_fused_contextual_attention_matches_dense(cuda):
    rs = np.random.RandomState(0)
    f = torch.from_numpy(rs.randn(2, 96, 32, 32).astype(np.float32)).to(cuda)
    mask = torch.from_numpy((rs.rand(2, 1, 32, 32) > 0.5).astype(np.float32)
                            ).to(cuda)
    got = contextual_attention_fused(f, f, mask)
    torch.testing.assert_close(got, contextual_attention(f, f, mask),
                               **TOL[torch.float32])


def test_kernel_rejects_cpu_mix(cuda):
    Q, K, V, keep = _inputs(0, 1, 8, 8, 8, 1.0, torch.float32, cuda)
    with pytest.raises(ValueError):
        attention_core(Q, K, V, keep.cpu())


def _op_args(op_name, device, seed=0, B=2, N=130, P=150, D=70):
    """Inputs of the custom op ``op_name`` on ``device``, at ragged
    shapes."""
    rs = np.random.RandomState(seed)

    def t(*shape, s=1.0):
        return torch.from_numpy((rs.randn(*shape) * s).astype(np.float32)
                                ).to(device)

    Q, K, V = t(B, N, D, s=D ** -0.5), t(B, P, D), t(B, P, D)
    keep = torch.from_numpy((rs.rand(B, P) > 0.3).astype(np.float32)
                            ).to(device)
    ks = torch.from_numpy((rs.rand(B, D) + 0.5).astype(np.float32)).to(device)
    dO, delta = t(B, N, D), t(B, N)
    lse = torch.logsumexp(torch.bmm(Q, (K * ks[:, None]).transpose(1, 2))
                          * keep[:, None] * 10.0, -1)
    f32 = torch.float32
    return {
        "fwd": (Q, K, V, keep, ks, 10.0, f32, True),
        "fwd_shared": (V, ks, keep, 10.0, f32, True),
        "fwd_dsplit": (Q, K, V, keep, ks, 10.0, f32, True),
        "dq": (Q, K, V, keep, lse, delta, dO, 10.0, ks),
        "dkdv": (Q, K, V, keep, lse, delta, dO, 10.0, ks),
        "bwd": (Q, K, V, keep, lse, delta, dO, 10.0, ks),
        "dv": (Q, K, keep, lse, dO, 10.0, ks),
        "dk": (Q, K, V, keep, lse, delta, dO, 10.0, ks),
    }[op_name]


OP_COUNTERS = {"fwd": "LAUNCHES", "fwd_shared": "LAUNCHES_SHARED",
               "fwd_dsplit": "LAUNCHES_DSPLIT", "dq": "LAUNCHES_DQ",
               "dkdv": "LAUNCHES_DKDV", "bwd": "LAUNCHES_BWD",
               "dv": "LAUNCHES_DV",
               "dk": "LAUNCHES_DK"}


@pytest.mark.parametrize("op_name", sorted(OP_COUNTERS))
def test_custom_op_on_cuda_matches_its_cpu_implementation(cuda, op_name):
    """Each torch.library op launches its kernel on CUDA tensors (one count)
    and agrees with its CPU implementation, the plain version, on the same
    inputs: forwards (out and lse) at the forward tolerance, backwards at
    2e-4 of each output's max |value|."""
    op = getattr(torch.ops.sketchedit, f"attention_{op_name}")
    args = _op_args(op_name, cuda)
    counter = OP_COUNTERS[op_name]
    before = getattr(attention_cuda, counter)
    got = op(*args)
    torch.cuda.synchronize()
    assert getattr(attention_cuda, counter) == before + 1
    want = op(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and g.shape == w.shape
        tol = (TOL[torch.float32] if op_name.startswith("fwd")
               else dict(rtol=0, atol=2e-4 * w.abs().max().item()))
        torch.testing.assert_close(g.cpu(), w, **tol)


@pytest.mark.parametrize("op_name", sorted(OP_COUNTERS))
def test_opcheck_on_cuda(cuda, op_name):
    """torch.library.opcheck on CUDA inputs: the schema, the fake
    implementation against the kernel's outputs, and the traced graph."""
    op = getattr(torch.ops.sketchedit, f"attention_{op_name}").default
    result = torch.library.opcheck(op, _op_args(op_name, cuda, N=40, P=50,
                                                D=36))
    assert set(result.values()) == {"SUCCESS"}, result


def test_artifact_exported_and_loaded_on_the_card(cuda, tmp_path):
    """server/artifact.py on the card: the loaded program launches the
    forward kernel once per call and gives the live edit's uint8 output
    within 1 LSB (the same kernels and convs on the same card)."""
    from sketchedit_tpu_torch.models import editline2
    from sketchedit_tpu_torch.server.artifact import (
        export_edit_artifact, load_edit_artifact)
    model = editline2.EditLine2(device=cuda)
    editline2.init_nets_(model, ("M", "G"), 0, init_type="kaiming")
    with torch.no_grad():
        for net, gain in ((model.netM, 1.8), (model.netG, 1.5)):
            for conv in net.children():
                conv.weight.mul_(gain)
    model.eval()
    path = str(tmp_path / "edit.pt2")
    meta = export_edit_artifact(model, path, size=64, batch=2)
    assert meta["platforms"] == ["cuda"] and meta["forward_kernel"] == "default"
    call = load_edit_artifact(path)
    rs = np.random.RandomState(3)
    img = torch.from_numpy(rs.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8))
    sk = torch.from_numpy(((rs.rand(2, 64, 64, 1) > 0.9) * 255).astype(
        np.uint8))
    before = attention_cuda.LAUNCHES
    with torch.inference_mode():
        got = call(img, sk)
        torch.cuda.synchronize()
        assert attention_cuda.LAUNCHES == before + 1
        want = editline2.edit_u8(model, img.to(cuda), sk.to(cuda))
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == torch.uint8
        assert (g.int() - w.int()).abs().max().item() <= 1
