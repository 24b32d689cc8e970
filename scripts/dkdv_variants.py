#!/usr/bin/env python3
"""Time design choices of the fused dK/dV backward (its wgmma sequence)
against each other and against an older checkout, on one GPU, in one run,
in turns.

    python3 scripts/dkdv_variants.py [--variants committed nogroup ...]
        [--parent DIR] [--seeds N]

The harness is scripts/dsplit_variants.py's: each variant is a copy of this
checkout's sketchedit_tpu_torch with a few textual edits to
csrc/contextual_attention_bwd.cu (an edit whose anchor is missing fails the
run) under results/dkdv_variants/<name>/, where it builds its own kernels;
all build in parallel, then each is timed in its own process, in the order
given and then in reverse, so two variants run A B B A. ``--parent DIR``
adds another checkout as it is (an unpacked parent commit) as the variant
``parent``. Variants:

  committed  the sequence as committed: the split copies; then per chunk of
             key rows S and dP in blocks of 64 queries x 128 keys, their
             k8 steps summed in runs of 16, each run added to the total
             with Kahan's compensation (in registers); the weights pass;
             dV and dK in blocks of 128 keys x 128 columns (two
             warpgroups over the rows sharing each B box), dK 64 x 256 in
             bfloat16, every step added to the total
  nogroup    S and dP add every k8 step to the total (one chain of 192 at
             D = 1536): what the grouped sum costs
  nokahan    S and dP add their runs to the total without Kahan's
             compensation
  gradcols   dV and dK in blocks of 64 keys x 256 columns in both dtypes
             (warpgroups side by side, each B box its own)
  gradgroup  dV and dK summed in runs of 16 k8 steps as S and dP are, in
             warpgroup tiles 64 columns wide
  group8     S and dP summed in runs of 8 k8 steps
  group32    S and dP summed in runs of 32 k8 steps
  hifirst    every k8 step's hi x hi pass first into the fresh
             accumulator, the split terms' passes added after it (an edit
             to the product's body, so the copy's forwards take it too)

One JSON line per variant, shape and dtype: the fused dK/dV's ms (CUDA
events after warm-up) and its host ms per call (the enqueue alone,
``dkdv_host_ms``), the largest |difference| from its plain version as a
share of each gradient's max, the launch plan where the checkout has
``dkdv_scratch``, the device time of each phase of one call from
torch.profiler (``phase_ms``: the split copies, S and dP together, the
weights, dV and dK together; the older checkout's one cluster kernel as
``cluster``), and the card's name and power limit; ``committed`` and
``parent`` also time dQ and the dV + dK pair that the fused sequence
replaces (``pair_ms``). Each gradient's distance from a float64
evaluation of the same function (relative L2 and max |difference| over
max |value|: ``f64``) is given for the fused sequence and, in
``committed`` and ``parent``, for the dK and dV kernels (``f64_alone``);
at 256^2 and at a ragged 116^2 (N = P = 169), B = 3. ``--seeds N``
times nothing: it gives those distances at 256^2, B = 1, in both dtypes,
for inputs made from seeds 0 .. N - 1, one line each. A `ptxas` line per product instantiation gives
registers and spills. Shapes as on the training path (chip_smoke.py's
inputs): 256^2 (B = 8 and 1), D = 1536, float32 and bfloat16. Needs a GPU.

``BWD``, ``COMMON``, ``CVT`` and ``edit_source`` serve
scripts/tf32_split_ab.py.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dsplit_variants import ROOT, card, drive, make, report_ptxas  # noqa: E402
from fwd_variants import host_ms  # noqa: E402

OUT = os.path.join(ROOT, "results", "dkdv_variants")
BWD = os.path.join("sketchedit_tpu_torch", "csrc",
                   "contextual_attention_bwd.cu")
COMMON = os.path.join("sketchedit_tpu_torch", "csrc",
                      "contextual_attention_common.cuh")
WGMMA = os.path.join("sketchedit_tpu_torch", "csrc",
                     "contextual_attention_wgmma.cuh")
# to_tf32's split rounded by cvt.rna.tf32.f32 instead of on the bits
CVT = [("""    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
""", """    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
""")]

# variant -> (edits to contextual_attention_bwd.cu, edits to the product's
# body in contextual_attention_wgmma.cuh, which the copy's forward shares)
VARIANTS = {
    "committed": ([], []),
    "nogroup": ([("constexpr int kScoreGroup = kSumStages;",
                  "constexpr int kScoreGroup = 0;")], []),
    "nokahan": ([("constexpr bool kScoreKahan = true;",
                  "constexpr bool kScoreKahan = false;")], []),
    "gradcols": ([("using GradGemm = Gemm<kGradCols, kSplitB ? 2 : 1, kSplitB>;",
                   "using GradGemm = Gemm<kGradCols, 1, kSplitB>;")], []),
    "gradgroup": ([("constexpr int kGradCols = 96;",
                    "constexpr int kGradCols = 64;"),
                   ("constexpr int kGradGroup = 0;",
                    "constexpr int kGradGroup = kSumStages;")], []),
    "group8": ([("constexpr int kScoreGroup = kSumStages;",
                 "constexpr int kScoreGroup = 2;")], []),
    "group32": ([("constexpr int kScoreGroup = kSumStages;",
                  "constexpr int kScoreGroup = 8;")], []),
    "hifirst": ([], [("""  wgmma_tf32<kN>(f, al, bh, 0);
  if constexpr (kSplitB) wgmma_tf32<kN>(f, ah, bl, 1);
  wgmma_tf32<kN>(f, ah, bh, 1);""", """  wgmma_tf32<kN>(f, ah, bh, 0);
  if constexpr (kSplitB) wgmma_tf32<kN>(f, ah, bl, 1);
  wgmma_tf32<kN>(f, al, bh, 1);""")]),
}
SHAPES = ((8, 64, "float32"), (8, 64, "bfloat16"), (1, 64, "float32"),
          (1, 64, "bfloat16"), (3, 29, "float32"), (3, 29, "bfloat16"))
# profiler kernel name -> phase of the fused dK/dV
PHASES = (("ca_dkdv_split", "prep"), ("ca_dkdv_wgmma_kernel<64,", "s_dp"),
          ("ca_dkdv_weights", "weights"), ("ca_dkdv_wgmma_kernel<", "dv_dk"),
          ("ca_dkdv_kernel", "cluster"))


def edit_source(root: str, source: str, edits):
    """Apply the textual ``edits`` (old, new) to ``source`` in the copy at
    ``root``, as ``make`` does to the kernel's file."""
    path = os.path.join(root, source)
    with open(path) as fh:
        src = fh.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"anchor not found once in {source}: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    with open(path, "w") as fh:
        fh.write(src)


def phase_ms(fn) -> dict:
    """Device ms of each phase of one call of ``fn`` (torch.profiler),
    summed over its launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for key, phase in PHASES:
            if key in ev.key:
                t = getattr(ev, "device_time_total", None)
                if t is None:
                    t = ev.cuda_time_total
                out[phase] = out.get(phase, 0.0) + t / 1e3
    return out


def float64_dist(got, args) -> dict:
    """Each gradient of ``got`` (dK_eff, dV) against a float64 evaluation
    of the same function from the same inputs: relative L2, and the
    largest |difference| over the largest |value|."""
    Q, K, V, keep, lse, delta, dO, scale, ks = (
        t.double() if hasattr(t, "double") else t for t in args)
    g = keep[:, None, :] * scale
    P = ((Q @ (K * ks[:, None, :]).transpose(1, 2)) * g
         - lse[..., None]).exp()
    dS = P * (dO @ V.transpose(1, 2) - delta[..., None]) * g
    want = (dS.transpose(1, 2) @ Q, P.transpose(1, 2) @ dO)
    out = {}
    for name, a, w in zip(("dK_eff", "dV"), got, want):
        d = a.double() - w
        out[name] = {"rel_l2": (d.norm() / w.norm()).item(),
                     "max_abs_rel": (d.abs().max() / w.abs().max()).item()}
    return out


def seed_rows(name: str, seeds: int, card_: str):
    """One line per seed and dtype at 256^2, B = 1: each gradient's
    distance from float64, the fused sequence's and the dV and dK
    kernels'."""
    import numpy as np
    import torch

    from chip_smoke import features, hole_mask
    from sketchedit_tpu_torch.ops import attention_cuda as ac
    for seed in range(seeds):
        for dtype in (torch.float32, torch.bfloat16):
            rs = np.random.RandomState(seed)
            f = features(rs, 1, 64, 64).cuda().to(dtype)
            Q, V, keep, ksc = ac.attention_inputs(f, f,
                                                  hole_mask(1, 64, 64).cuda())
            out, lse = ac.attention_core(Q, V, V, keep, return_lse=True,
                                         out_dtype=torch.float32, kscale=ksc)
            dO = torch.from_numpy(rs.randn(*Q.shape).astype(np.float32)
                                  ).cuda()
            bargs = (Q, V, V, keep, lse, (dO * out).sum(-1), dO, 10.0, ksc)
            fused = float64_dist(ac.attention_core_dkdv(*bargs), bargs)
            alone = float64_dist((ac.attention_core_dk(*bargs),
                                  ac.attention_core_dv(Q, V, keep, lse, dO,
                                                       10.0, ksc)), bargs)
            print(json.dumps({
                "variant": name, "seed": seed,
                "dtype": str(dtype).split(".")[-1], "card": card_,
                "f64": fused, "f64_alone": alone,
                "fused_x_alone": {k: {m: fused[k][m] / alone[k][m]
                                      for m in fused[k]} for k in fused}}),
                flush=True)


def grad_layout(f32: bool, B: int, N: int, P: int, D: int, rows: int):
    """Byte offsets of the fused dK/dV's scratch parts where V is K, as
    csrc/contextual_attention_bwd.cu's grad_layout lays them out."""
    r4 = lambda x: (x + 3) // 4 * 4
    Dp, Np, ld = r4(D), r4(N), r4(rows)
    at, off = 0, {}
    for name, nbytes, take in (
            ("kh", 4 * B * P * Dp, True), ("kl", 4 * B * P * Dp, f32),
            ("qh", 4 * B * N * Dp, True), ("ql", 4 * B * N * Dp, True),
            ("oh", 4 * B * N * Dp, True), ("ol", 4 * B * N * Dp, True),
            ("qth", 4 * B * D * Np, True), ("qtl", 4 * B * D * Np, f32),
            ("oth", 4 * B * D * Np, True), ("otl", 4 * B * D * Np, True),
            ("s", 4 * B * N * ld, True), ("dp", 4 * B * N * ld, True),
            ("ph", 4 * B * rows * Np, True), ("pl", 4 * B * rows * Np, True),
            ("dh", 4 * B * rows * Np, True), ("dl", 4 * B * rows * Np, True)):
        if take:
            off[name] = at
            at = (at + nbytes + 255) // 256 * 256
    return off, ld, Np


def stage_rows(name: str, seed: int, card_: str):
    """Where the fused sequence's distance from float64 arises, at 256^2,
    B = 1 on the inputs of ``seed``, in both dtypes: the sequence is run
    on a scratch held here (one chunk), and S, dP, P^T and dS^T are read
    back from it. Each line: S's and dP's largest |difference| over their
    largest |value|; dK_eff and dV as the kernel gives them, and as a
    float64 product of the kernel's own dS^T and P^T terms with Q and dO
    (so the gradients' error before their last product)."""
    import numpy as np
    import torch

    from chip_smoke import features, hole_mask
    from sketchedit_tpu_torch.ops import attention_cuda as ac
    for dtype in (torch.float32, torch.bfloat16):
        rs = np.random.RandomState(seed)
        f = features(rs, 1, 64, 64).cuda().to(dtype)
        Q, V, keep, ksc = ac.attention_inputs(f, f, hole_mask(1, 64, 64).cuda())
        out, lse = ac.attention_core(Q, V, V, keep, return_lse=True,
                                     out_dtype=torch.float32, kscale=ksc)
        dO = torch.from_numpy(rs.randn(*Q.shape).astype(np.float32)).cuda()
        delta = (dO * out).sum(-1)
        B, N, D = Q.shape
        nbytes, rows = ac.dkdv_scratch(B, N, N, D, dtype)
        assert rows == N
        scratch = torch.zeros(nbytes, dtype=torch.uint8, device="cuda")
        dK, dV = (torch.empty(V.shape, device="cuda") for _ in range(2))
        ac._launch_bwd("dkdv", Q, V, (Q, V, V, keep, ksc, dO, lse, delta, dK,
                                      dV, scratch), 10.0, (rows,))
        torch.cuda.synchronize()
        off, ld, Np = grad_layout(dtype == torch.float32, B, N, N, D, rows)
        fl = scratch.view(torch.float32)
        part = lambda k, n, shape: fl[off[k] // 4:off[k] // 4 + n].view(shape)
        S = part("s", B * N * ld, (B, N, ld))[..., :N].double()
        dP = part("dp", B * N * ld, (B, N, ld))[..., :N].double()
        terms = lambda h, l: (part(h, B * N * Np, (B, N, Np)).double()
                              + part(l, B * N * Np, (B, N, Np)).double()
                              )[..., :N]
        PT, dST = terms("ph", "pl"), terms("dh", "dl")
        Qd, Vd, dOd = Q.double(), V.double(), dO.double()
        S64 = Qd @ (Vd * ksc.double()[:, None, :]).transpose(1, 2)
        dP64 = dOd @ Vd.transpose(1, 2)
        g = keep.double()[:, None, :] * 10.0
        P64 = (S64 * g - lse.double()[..., None]).exp()
        dS64 = P64 * (dP64 - delta.double()[..., None]) * g
        want = (dS64.transpose(1, 2) @ Qd, P64.transpose(1, 2) @ dOd)
        rel = lambda a, w: (a - w).abs().max().item() / w.abs().max().item()
        l2 = lambda a, w: ((a - w).norm() / w.norm()).item()
        row = {"variant": name, "seed": seed,
               "dtype": str(dtype).split(".")[-1], "card": card_,
               "S": rel(S, S64), "dP": rel(dP, dP64),
               "dST": rel(dST, dS64.transpose(1, 2)),
               "PT": rel(PT, P64.transpose(1, 2))}
        for k, got, terms, w, b in (("dK_eff", dK, dST, want[0], Qd),
                                    ("dV", dV, PT, want[1], dOd)):
            row[k] = {"kernel": [rel(got.double(), w), l2(got.double(), w)],
                      "from_terms": [rel(terms @ b, w), l2(terms @ b, w)]}
        print(json.dumps(row), flush=True)


def time_variant(root: str, name: str):
    sys.path[:0] = [root, ROOT]
    import numpy as np
    import torch

    from chip_smoke import cuda_ms, features, hole_mask
    from sketchedit_tpu_torch.ops import attention_cuda as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    card_ = card()
    seeds = int(os.environ.get("DKDV_VARIANTS_SEEDS", "0"))
    if seeds:
        return seed_rows(name, seeds, card_)
    stages = int(os.environ.get("DKDV_VARIANTS_STAGES", "-1"))
    if stages >= 0:
        return stage_rows(name, stages, card_)
    rs = np.random.RandomState(0)
    for B, hw, dtype in SHAPES:
        timed = hw == 64
        f = features(rs, B, hw, hw).cuda().to(getattr(torch, dtype))
        Q, V, keep, ksc = ac.attention_inputs(f, f, hole_mask(B, hw, hw).cuda())
        out, lse = ac.attention_core(Q, V, V, keep, return_lse=True,
                                     out_dtype=torch.float32, kscale=ksc)
        dO = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            0)).cuda()
        bargs = (Q, V, V, keep, lse, (dO * out).sum(-1), dO, 10.0, ksc)
        B, N, D = Q.shape
        reps = 10 if B > 1 else 20
        dkdv = lambda: ac.attention_core_dkdv(*bargs)
        row = {"variant": name, "image_hw": [4 * hw, 4 * hw],
               "shape_BNPD": [B, N, N, D], "dtype": dtype, "card": card_}
        if timed:
            row["dkdv_ms"] = cuda_ms(dkdv, reps)
            row["dkdv_host_ms"] = host_ms(dkdv)
        if timed and name in ("committed", "parent"):
            row["pair_ms"] = cuda_ms(lambda: (
                ac.attention_core_dv(Q, V, keep, lse, dO, 10.0, ksc),
                ac.attention_core_dk(*bargs)), reps)
            row["dq_ms"] = cuda_ms(lambda: ac.attention_core_dq(*bargs), reps)
        got = dkdv()
        want = ac.attention_core_dkdv_reference(*bargs)
        row["max_abs_err_rel"] = max(
            ((g - w).abs().max() / w.abs().max().clamp_min(1e-6)).item()
            for g, w in zip(got, want))
        row["f64"] = float64_dist(got, bargs)
        if name in ("committed", "parent"):
            row["f64_alone"] = float64_dist(
                (ac.attention_core_dk(*bargs), ac.attention_core_dv(
                    Q, V, keep, lse, dO, 10.0, ksc)), bargs)
        if hasattr(ac, "dkdv_scratch"):
            row["plan"] = ac.dkdv_plan(B, N, N, D, Q.dtype)
        if timed:
            row["phase_ms"] = phase_ms(dkdv)
        print(json.dumps(row), flush=True)
        del f, Q, V, out, dO, bargs, got, want


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=["committed"],
                    choices=list(VARIANTS))
    ap.add_argument("--parent", help="another checkout, timed as it is")
    ap.add_argument("--seeds", type=int, default=0,
                    help="float64 distances over this many seeds, no times")
    ap.add_argument("--stages", type=int, default=-1, metavar="SEED",
                    help="each phase's distance from float64 on the "
                         "inputs of SEED, no times")
    ap.add_argument("--build", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--time", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        kernel = ("ca_dkdv_kernel" if args.build[1] == "parent"
                  else "ca_dkdv_wgmma_kernel")
        return report_ptxas(*args.build, "contextual_attention_bwd", kernel)
    if args.time:
        return time_variant(*args.time)
    os.environ["DKDV_VARIANTS_SEEDS"] = str(args.seeds)
    os.environ["DKDV_VARIANTS_STAGES"] = str(args.stages)
    names = list(dict.fromkeys(args.variants))
    roots = {name: make(name, VARIANTS[name][0], BWD, ROOT, OUT)
             for name in names}
    for name in names:
        edit_source(roots[name], WGMMA, VARIANTS[name][1])
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    drive(__file__, roots)


if __name__ == "__main__":
    main()
