#!/usr/bin/env python3
"""Time design choices of the wgmma default and shared attention forwards
against each other, and against an older checkout, on one GPU, in one run,
in turns.

    python3 scripts/fwd_variants.py [--variants committed wait0 ...]
        [--parent DIR]

The harness is scripts/dsplit_variants.py's: each variant is a copy of this
checkout's sketchedit_tpu_torch with a few textual edits to
csrc/contextual_attention_fwd.cu or to the product's body in
csrc/contextual_attention_wgmma.cuh (an edit whose anchor is missing fails
the run) under results/fwd_variants/<name>/, where it builds its own kernels;
all build in parallel, then each is timed in its own process, in the order
given and then in reverse, so two variants run A B B A. ``--parent DIR``
adds another checkout as it is (an unpacked parent commit) as the variant
``parent``. Variants:

  committed  the kernels as committed: S in blocks of 64 query rows x 128
             keys (two warpgroups side by side); P V in blocks of 128
             rows x 96 output columns in float32 (two warpgroups one above
             the other, sharing each V box), 64 x 192 in bfloat16; each
             warpgroup alternates two fresh accumulators inside a stage
  pvcols     P V in blocks of 64 x 192 in float32 too
  wait0      one fresh accumulator, each k8 step waited for (wait_group
             0) and added before the next is issued

One JSON line per variant, shape and dtype: the default and shared
forwards' ms (CUDA events after warm-up, float32 output as on the main
path) and the default one's host ms per call (its enqueue alone,
``fwd_host_ms``), a digest of the default one's output and lse
(``fwd_digest``: two checkouts whose kernels compute the same bits give
the same digest), the largest |difference| of each from the plain version, the launch
plan where the checkout has ``fwd_scratch``, the device time of each phase
of one default call from torch.profiler (``phase_ms``: the split keys and
queries, the transposed values, the logits product, the softmax, the P V
product; where the checkout runs the wgmma forwards), and the card's name
and power limit. ``committed`` and ``parent`` also time the D-split forward
and, at 256^2, B = 8 (the training shape), dQ, the fused dK/dV, dV and dK.
A `ptxas` line per product instantiation gives registers and spills, and
the build's ``wgmma ... serialized`` notes are counted. Shapes as on the
main path (chip_smoke.py's inputs): 256^2 (B = 1 and 8), 512^2 and 1024^2
(B = 1), D = 1536, float32 and bfloat16. Needs a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dsplit_variants import ROOT, card, drive, make, report_ptxas  # noqa: E402

OUT = os.path.join(ROOT, "results", "fwd_variants")
FWD = os.path.join("sketchedit_tpu_torch", "csrc", "contextual_attention_fwd.cu")
WGMMA = os.path.join("sketchedit_tpu_torch", "csrc",
                     "contextual_attention_wgmma.cuh")

STEP_WAIT = """  wg_wait<1>();  // the previous step's group is done
  pin(prev);
  if (add_prev) {
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) acc[i] += prev[i];
  }"""
STAGE_END = """  wg_wait<0>();
  pin(f1);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) sum[i] += f1[i];
"""
# variant -> (edits to contextual_attention_fwd.cu, edits to the product's
# body in contextual_attention_wgmma.cuh)
VARIANTS = {
    "committed": ([], []),
    "pvcols": ([("using OutGemm = Gemm<kOutCols, kF32 ? kOutRowGroups : 1, kF32>;",
                 "using OutGemm = Gemm<kOutCols, 1, kF32>;")], []),
    "wait0": ([], [(STEP_WAIT, """  wg_wait<0>();
  pin(f);
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] += f[i];"""), (STAGE_END, "")]),
}
SHAPES = ((1, 64, "float32"), (8, 64, "float32"), (1, 128, "float32"),
          (1, 256, "float32"), (1, 64, "bfloat16"), (8, 64, "bfloat16"),
          (1, 128, "bfloat16"), (1, 256, "bfloat16"))
# profiler kernel name -> phase of the wgmma forwards
PHASES = (("split_rows", "keys_queries"), ("split_vt", "values"),
          ("true, float>", "logits"), ("softmax", "softmax"),
          ("false, float>", "pv"), ("false, __nv_bfloat16>", "pv"))


def phase_ms(fn) -> dict:
    """Device ms of each phase of one call of ``fn`` (torch.profiler),
    summed over its launches; empty where no wgmma forward ran."""
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


def host_ms(fn, reps: int = 20) -> float:
    """Host milliseconds per call of ``fn`` (its enqueue, no synchronise
    inside the window): above the device time, the host sets the pace."""
    import time

    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def time_variant(root: str, name: str):
    sys.path[:0] = [root, ROOT]
    import numpy as np
    import torch

    from chip_smoke import cuda_ms, features, hole_mask
    from sketchedit_tpu_torch.ops import attention_cuda as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    card_ = card()
    rs = np.random.RandomState(0)
    f32 = torch.float32
    others = name in ("committed", "parent")
    for B, hw, dtype in SHAPES:
        f = features(rs, B, hw, hw).cuda().to(getattr(torch, dtype))
        Q, V, keep, ksc = ac.attention_inputs(f, f, hole_mask(B, hw, hw).cuda())
        B, N, D = Q.shape
        reps = 10 if hw == 64 else (5 if hw == 128 else 2)
        fwd = lambda: ac.attention_core(Q, V, V, keep, out_dtype=f32,
                                        kscale=ksc)
        shared = lambda: ac.attention_core_shared(V, ksc, keep, out_dtype=f32)
        row = {"variant": name, "image_hw": [4 * hw, 4 * hw],
               "shape_BNPD": [B, N, N, D], "dtype": dtype, "card": card_,
               "fwd_ms": cuda_ms(fwd, reps, warmup=1),
               "shared_ms": cuda_ms(shared, reps, warmup=1),
               "fwd_host_ms": host_ms(fwd)}
        got = ac.attention_core(Q, V, V, keep, return_lse=True,
                                out_dtype=f32, kscale=ksc)
        row["fwd_digest"] = hashlib.sha1(torch.cat(
            [t.flatten() for t in got]).cpu().numpy().tobytes()
        ).hexdigest()[:16]
        del got
        if hw < 256:
            want = ac.attention_core_reference(Q, V, V, keep, out_dtype=f32,
                                               kscale=ksc)
            row["fwd_max_abs_err"] = (fwd() - want).abs().max().item()
            row["shared_max_abs_err"] = (shared() - want).abs().max().item()
            del want
        if hasattr(ac, "fwd_scratch"):
            row["plan"] = ac.fwd_plan(B, N, N, D, Q.dtype)
        row["phase_ms"] = phase_ms(fwd)
        if others:
            row["dsplit_ms"] = cuda_ms(lambda: ac.attention_core_dsplit(
                Q, V, V, keep, out_dtype=f32, kscale=ksc), reps, warmup=1)
        if others and (B, hw) == (8, 64):
            out, lse = ac.attention_core(Q, V, V, keep, return_lse=True,
                                         out_dtype=f32, kscale=ksc)
            dO = torch.randn(out.shape, generator=torch.Generator(
                ).manual_seed(0)).cuda()
            bargs = (Q, V, V, keep, lse, (dO * out).sum(-1), dO, 10.0, ksc)
            row["dq_ms"] = cuda_ms(lambda: ac.attention_core_dq(*bargs), 10)
            row["dkdv_ms"] = cuda_ms(lambda: ac.attention_core_dkdv(*bargs),
                                     10)
            row["dv_ms"] = cuda_ms(lambda: ac.attention_core_dv(
                Q, V, keep, lse, dO, 10.0, ksc), 10)
            row["dk_ms"] = cuda_ms(lambda: ac.attention_core_dk(*bargs), 10)
            del out, lse, dO, bargs
        print(json.dumps(row), flush=True)
        del f, Q, V


def report_build(root: str, name: str):
    """Registers and spills of each product instantiation, and the count of
    ptxas's notes that it serialized wgmma instructions."""
    report_ptxas(root, name, "contextual_attention_fwd", "ca_fwd_wgmma_kernel")
    from sketchedit_tpu_torch.ops import _build
    log = _build.build_log.get("contextual_attention_fwd", "")
    print(json.dumps({"ptxas": name, "wgmma_serialized_notes": sum(
        "serialized" in ln for ln in log.splitlines())}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=["committed"],
                    choices=list(VARIANTS))
    ap.add_argument("--parent", help="another checkout, timed as it is")
    ap.add_argument("--build", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--time", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        if args.build[1] == "parent":
            sys.path.insert(0, args.build[0])
            from sketchedit_tpu_torch.ops import _build
            _build.load()
            return None
        return report_build(*args.build)
    if args.time:
        return time_variant(*args.time)
    from dkdv_variants import edit_source
    names = list(dict.fromkeys(args.variants))
    roots = {name: make(name, VARIANTS[name][0], FWD, ROOT, OUT)
             for name in names}
    for name in names:
        edit_source(roots[name], WGMMA, VARIANTS[name][1])
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    drive(__file__, roots)


if __name__ == "__main__":
    main()
