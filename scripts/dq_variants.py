#!/usr/bin/env python3
"""Time design choices of the dQ backward (its wgmma sequence) against each
other and against an older checkout, on one GPU, in one run, in turns.

    python3 scripts/dq_variants.py [--variants committed cols192 ...]
        [--parent DIR] [--seeds N]

The harness is scripts/dsplit_variants.py's: each variant is a copy of this
checkout's sketchedit_tpu_torch with a few textual edits to
csrc/contextual_attention_bwd.cu (an edit whose anchor is missing fails the
run) under results/dq_variants/<name>/, where it builds its own kernels;
all build in parallel, then each is timed in its own process, in the order
given and then in reverse, so two variants run A B B A. ``--parent DIR``
adds another checkout as it is (an unpacked parent commit) as the variant
``parent``. Variants:

  committed  the sequence as committed: the split copies (K by rows, K
             transposed, Q kscale and dO by rows); then per chunk of query
             rows S and dP in blocks of 64 queries x 128 keys, their k8
             steps summed in runs of 16, each run added to the total with
             Kahan's compensation; the weights pass writing dS by rows;
             dQ = dS K in blocks of 128 queries x 128 columns (two
             warpgroups over the rows sharing each B box), 64 x 256 in
             bfloat16, every step added to the total, kscale on the
             columns in the epilogue
  cols192    dQ's product in blocks of 64 queries x 256 columns in float32
             too (warpgroups side by side, each B box its own)
  nokahan    S and dP add their runs to the total without Kahan's
             compensation (the constant is shared, so the copy's fused
             dK/dV takes it too; only dQ is read here)

One JSON line per variant, shape and dtype: dQ's ms (CUDA events after
warm-up, the main path's call: Q = K = V one tensor, kscale, float32 dO)
and its host ms per call (the enqueue alone, ``dq_host_ms``), its largest
|difference| from the plain version as a share of max |dQ|, the launch plan
where the checkout has ``dq_scratch``, the device time of each phase of
one call from torch.profiler (``phase_ms``: the split copies, S and dP
together, the weights, the dQ product; the older checkout's one mma.sync
kernel as ``mma_sync``), dQ's and the fused dK/dV's dK_eff's distance from
a float64 evaluation of the same function (relative L2 and max
|difference| over max |value|: ``f64``) and their ratio
(``dq_x_dk_rel_l2``, the precision bar's figure), and the card's name and
power limit. ``committed`` and ``parent`` also time the default forward
(float32 output) and the fused dK/dV and give a digest of each one's
outputs (``fwd_digest``, ``dkdv_digest``: two checkouts whose kernels
compute the same bits give the same digest). ``--seeds N`` times nothing:
it gives those distances at 256^2, B = 1 and 8, float32, for inputs made
from seeds 0 .. N - 1, and at tests/test_torch_kernels.py's float64 inputs
(``_main_path_bwd``; B, H = 1, 64 and 3, 29, both dtypes), one line each.
A `ptxas` line per dQ product instantiation gives registers and spills.
Shapes as on the training path (chip_smoke.py's inputs): 256^2, B = 1 and
8, D = 1536, float32 and bfloat16. Needs a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dsplit_variants import ROOT, card, drive, make, report_ptxas  # noqa: E402
from fwd_variants import host_ms  # noqa: E402

OUT = os.path.join(ROOT, "results", "dq_variants")
BWD = os.path.join("sketchedit_tpu_torch", "csrc",
                   "contextual_attention_bwd.cu")

VARIANTS = {
    "committed": [],
    "cols192": [(f"  using GQ = GradGemm<kF32>;\n{after}",
                 f"  using GQ = Gemm<kGradCols, 1, kF32>;\n{after}")
                for after in ("  // ms: S = (Q kscale) K^T",
                              "  if (rows <= 0 || rows > N)")],
    "nokahan": [("constexpr bool kScoreKahan = true;",
                 "constexpr bool kScoreKahan = false;")],
}
SHAPES = ((8, "float32"), (8, "bfloat16"), (1, "float32"), (1, "bfloat16"))
# profiler kernel name -> phase of dQ
PHASES = (("ca_dq_split", "prep"), ("ca_dq_wgmma_kernel<64,", "s_dp"),
          ("ca_dq_weights", "weights"), ("ca_dq_wgmma_kernel<", "dq"),
          ("ca_dq_kernel", "mma_sync"))


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


def digest(tensors) -> str:
    import torch
    return hashlib.sha1(torch.cat([t.flatten() for t in tensors]).cpu()
                        .numpy().tobytes()).hexdigest()[:16]


def float64_dist(ac, args) -> dict:
    """dQ and the fused dK/dV's dK_eff against a float64 evaluation of the
    same function from the same inputs: relative L2, and the largest
    |difference| over the largest |value|; and the ratio of the two
    relative L2s."""
    dq = ac.attention_core_dq(*args)
    dk = ac.attention_core_dkdv(*args)[0]
    Q, K, V, keep, lse, delta, dO, scale, ks = (
        t.double() if hasattr(t, "double") else t for t in args)
    g = keep[:, None, :] * scale
    Keff = K * ks[:, None, :]
    P = ((Q @ Keff.transpose(1, 2)) * g - lse[..., None]).exp()
    dS = P * (dO @ V.transpose(1, 2) - delta[..., None]) * g
    out = {}
    for name, a, w in (("dQ", dq, dS @ Keff),
                       ("dK_eff", dk, dS.transpose(1, 2) @ Q)):
        d = a.double() - w
        out[name] = {"rel_l2": (d.norm() / w.norm()).item(),
                     "max_abs_rel": (d.abs().max() / w.abs().max()).item()}
    out["dq_x_dk_rel_l2"] = out["dQ"]["rel_l2"] / out["dK_eff"]["rel_l2"]
    return out


def main_path_args(ac, rs, B, dtype):
    """The main path's backward arguments at 256^2 (chip_smoke.py's inputs):
    Q = K = V one tensor, kscale, the forward's lse, a seeded dO."""
    import numpy as np
    import torch

    from chip_smoke import features, hole_mask
    f = features(rs, B, 64, 64).cuda().to(dtype)
    Q, V, keep, ksc = ac.attention_inputs(f, f, hole_mask(B, 64, 64).cuda())
    out, lse = ac.attention_core(Q, V, V, keep, return_lse=True,
                                 out_dtype=torch.float32, kscale=ksc)
    dO = torch.from_numpy(rs.randn(*Q.shape).astype(np.float32)).cuda()
    return (Q, V, V, keep, lse, (dO * out).sum(-1), dO, 10.0, ksc)


def seed_rows(ac, name: str, seeds: int, card_: str):
    """One line per seed and batch at 256^2, float32, then one per GPU-test
    case: dQ's and dK_eff's distance from float64 and their ratio."""
    import numpy as np
    import torch

    for seed in range(seeds):
        for B in (1, 8):
            args = main_path_args(ac, np.random.RandomState(seed), B,
                                  torch.float32)
            print(json.dumps({"variant": name, "seed": seed,
                              "shape_BNPD": [B, 961, 961, 1536],
                              "dtype": "float32", "card": card_,
                              "f64": float64_dist(ac, args)}), flush=True)
            del args
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_kernels import _main_path_bwd
    for B, H in ((1, 64), (3, 29)):
        for dtype in (torch.float32, torch.bfloat16):
            args = _main_path_bwd(B * 100 + H + 5, B, H, dtype,
                                  torch.device("cuda"))
            print(json.dumps({"variant": name, "gpu_test": [B, H],
                              "dtype": str(dtype).split(".")[-1],
                              "card": card_,
                              "f64": float64_dist(ac, args)}), flush=True)


def time_variant(root: str, name: str):
    sys.path[:0] = [root, ROOT]
    import numpy as np
    import torch

    from chip_smoke import cuda_ms
    from sketchedit_tpu_torch.ops import attention_cuda as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    card_ = card()
    seeds = int(os.environ.get("DQ_VARIANTS_SEEDS", "0"))
    if seeds:
        return seed_rows(ac, name, seeds, card_)
    rs = np.random.RandomState(0)
    f32 = torch.float32
    others = name in ("committed", "parent")
    for B, dtype in SHAPES:
        bargs = main_path_args(ac, rs, B, getattr(torch, dtype))
        Q, V, _, keep, _, _, _, _, ksc = bargs
        B, N, D = Q.shape
        reps = 10 if B > 1 else 20
        dq = lambda: ac.attention_core_dq(*bargs)
        row = {"variant": name, "image_hw": [256, 256],
               "shape_BNPD": [B, N, N, D], "dtype": dtype, "card": card_,
               "dq_ms": cuda_ms(dq, reps), "dq_host_ms": host_ms(dq)}
        want = ac.attention_core_dq_reference(*bargs)
        row["dq_max_abs_err_rel"] = ((dq() - want).abs().max()
                                     / want.abs().max()).item()
        del want
        row["f64"] = float64_dist(ac, bargs)
        if hasattr(ac, "dq_scratch"):
            row["plan"] = ac.dq_plan(B, N, N, D, Q.dtype)
        row["phase_ms"] = phase_ms(dq)
        if others:
            fwd = lambda: ac.attention_core(Q, V, V, keep, return_lse=True,
                                            out_dtype=f32, kscale=ksc)
            dkdv = lambda: ac.attention_core_dkdv(*bargs)
            row["fwd_ms"] = cuda_ms(fwd, reps)
            row["dkdv_ms"] = cuda_ms(dkdv, reps)
            row["fwd_digest"] = digest(fwd())
            row["dkdv_digest"] = digest(dkdv())
        print(json.dumps(row), flush=True)
        del bargs, Q, V, keep, ksc


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=["committed"],
                    choices=list(VARIANTS))
    ap.add_argument("--parent", help="another checkout, timed as it is")
    ap.add_argument("--seeds", type=int, default=0,
                    help="float64 distances over this many seeds, no times")
    ap.add_argument("--build", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--time", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        kernel = ("ca_dq_kernel" if args.build[1] == "parent"
                  else "ca_dq_wgmma_kernel")
        return report_ptxas(*args.build, "contextual_attention_bwd", kernel)
    if args.time:
        return time_variant(*args.time)
    os.environ["DQ_VARIANTS_SEEDS"] = str(args.seeds)
    names = list(dict.fromkeys(args.variants))
    roots = {name: make(name, VARIANTS[name], BWD, ROOT, OUT)
             for name in names}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    drive(__file__, roots)


if __name__ == "__main__":
    main()
