#!/usr/bin/env python3
"""Time the joint backward (dQ, dK and dV from one sequence) against the dQ
and fused dK/dV sequences it replaces, here and in an older checkout, on
one GPU, in one run, in turns.

    python3 scripts/bwd_variants.py [--parent DIR] [--variants NAME ...]

The harness is scripts/dsplit_variants.py's: the checkout as committed
(``committed``), the design choices named by ``--variants`` (copies of
the committed kernels with their constants edited) and, with ``--parent
DIR``, another checkout as it is (an unpacked parent commit, ``parent``)
each build their kernels, then each is timed in its own process, in the
order given and then in reverse (committed, parent, parent, committed).
The variants are the ways of spending the warp-specialised product
block's registers (``contextual_attention_wgmma.cuh``, WarpSpec) that the
committed kernels do not take: ``cols96`` dQ, dV and dK in warpgroup tiles
of 64 x 96 (the forward's P V width) in place of 64 x 128, ``fresh2`` S
and dP with two fresh accumulators (one k8 step in flight) in place of
three, ``gradfresh3`` dQ, dV and dK with three in 64 x 96 tiles (three of
64 x 128 would not fit 232 registers). None changes an output element's
order of summation, so every one must give the committed digests. Each
build prints its product instantiations' registers and spills and any
ptxas note on ``wgmma`` serialisation or ``setmaxnreg``, and a
warp-specialised build whose products do not take 168 registers at launch
stops the run before anything is timed.

One JSON line per checkout, shape and dtype, at the main path's call (Q =
K = V one tensor, kscale, float32 dO; chip_smoke.py's inputs at 256^2, B =
8 and 1, D = 1536, float32 and bfloat16): the ms (CUDA events after
warm-up) of the dQ sequence and the fused dK/dV's one after the other
(``two_ms``; dQ and dK/dV alone, ``dq_ms`` and ``dkdv_ms``) and, where the
checkout has it, of the joint backward (``bwd_ms``), each one's host ms per
call (the enqueue alone), the device time of each phase of one call from
torch.profiler (``phase_ms``: the split copies, S and dP, the weights, dV
and dK, the dQ product; ``two`` summed over both sequences, ``bwd`` the
joint's), a digest of each route's outputs (dQ, dK_eff, dV:
``two_digest``, ``bwd_digest``; equal digests are equal bits), the joint's
launch plan, its largest |difference| from the plain version as a share of
each gradient's max, the library's backward (``F.scaled_dot_product_attention``
and its gradients through autograd on the same function, ``library_ms``),
a digest of the default forward's output and lse at the same inputs
(``fwd_digest``) and the card's name and power limit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dq_variants import digest, main_path_args  # noqa: E402
from dsplit_variants import (ROOT, card, drive, make,  # noqa: E402
                             report_ptxas)
from fwd_variants import host_ms  # noqa: E402

OUT = os.path.join(ROOT, "results", "bwd_variants")
BWD = os.path.join("sketchedit_tpu_torch", "csrc",
                   "contextual_attention_bwd.cu")
WGMMA = os.path.join("sketchedit_tpu_torch", "csrc",
                     "contextual_attention_wgmma.cuh")
SHAPES = ((8, "float32"), (8, "bfloat16"), (1, "float32"), (1, "bfloat16"))
# profiler kernel name -> phase, first match (S and dP's products are the
# 64-column ones)
PHASES = (("_split_", "prep"), ("wgmma_kernel<64,", "s_dp"),
          ("_weights", "weights"), ("ca_dkdv_wgmma_kernel<", "dv_dk"),
          ("ca_dq_wgmma_kernel<", "dq"))
COLS96 = [("constexpr int kGradCols = 128;", "constexpr int kGradCols = 96;")]
# variant -> edits to contextual_attention_bwd.cu's constants
VARIANTS = {"committed": [], "cols96": COLS96,
            "fresh2": [("constexpr int kScoreFresh = 3;",
                        "constexpr int kScoreFresh = 2;")],
            "gradfresh3": COLS96 + [("constexpr int kGradFresh = 2;",
                                     "constexpr int kGradFresh = 3;")]}


def phase_ms(fn, phases=PHASES) -> dict:
    """Device ms of each phase of one call of ``fn`` (torch.profiler),
    summed over its launches, and the launches counted; ``phases`` maps a
    kernel name's first matching part to its phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {"launches": 0}
    for ev in prof.key_averages():
        for key, phase in phases:
            if key in ev.key:
                t = getattr(ev, "device_time_total", None)
                if t is None:
                    t = ev.cuda_time_total
                out[phase] = out.get(phase, 0.0) + t / 1e3
                out["launches"] += ev.count
                break
    return out


def library_ms(bargs, cuda_ms, reps) -> float:
    """The library's backward on the same function: SDPA on the keys
    K kscale (10 keep) and its three gradients through autograd from a
    retained graph (chip_smoke.py's ``time_bwd_kernel``)."""
    import torch
    import torch.nn.functional as F
    Q, K, V, keep, _, _, dO, _, ksc = bargs
    Kg = (V.float() * ksc[:, None, :] * (10.0 * keep)[..., None]).to(Q.dtype)
    q_, k_, v_ = (t.detach().clone().requires_grad_() for t in (Q, Kg, V))
    o_ = F.scaled_dot_product_attention(q_, k_, v_, scale=1.0)
    g_ = dO.to(o_.dtype)
    return cuda_ms(lambda: torch.autograd.grad(o_, (q_, k_, v_), g_,
                                               retain_graph=True), reps)


def time_variant(root: str, name: str):
    sys.path[:0] = [root, ROOT]
    import numpy as np
    import torch

    from chip_smoke import cuda_ms
    from sketchedit_tpu_torch.ops import attention_cuda as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    card_ = card()
    rs = np.random.RandomState(0)
    joint = hasattr(ac, "attention_core_bwd_joint")
    for B, dtype in SHAPES:
        bargs = main_path_args(ac, rs, B, getattr(torch, dtype))
        N, D = bargs[0].shape[1:]
        reps = 10 if B > 1 else 20
        dq = lambda: ac.attention_core_dq(*bargs)
        dkdv = lambda: ac.attention_core_dkdv(*bargs)
        two = lambda: (dq(), *dkdv())
        Q, V, keep = bargs[0], bargs[1], bargs[3]
        fwd = ac.attention_core(Q, V, V, keep, return_lse=True,
                                out_dtype=torch.float32, kscale=bargs[8])
        row = {"variant": name, "image_hw": [256, 256],
               "shape_BNPD": [B, N, N, D], "dtype": dtype, "card": card_,
               "fwd_digest": digest(fwd),
               "two_ms": cuda_ms(two, reps), "dq_ms": cuda_ms(dq, reps),
               "dkdv_ms": cuda_ms(dkdv, reps), "two_host_ms": host_ms(two),
               "two_digest": digest(two())}
        phases = {"two": phase_ms(two)}
        if joint:
            bwd = lambda: ac.attention_core_bwd_joint(*bargs)
            row["bwd_ms"] = cuda_ms(bwd, reps)
            row["bwd_host_ms"] = host_ms(bwd)
            got = bwd()
            row["bwd_digest"] = digest(got)
            row["bwd_x_two"] = row["bwd_ms"] / row["two_ms"]
            want = ac.attention_core_bwd_joint_reference(*bargs)
            row["bwd_max_abs_err_rel"] = [
                ((g - w).abs().max() / w.abs().max()).item()
                for g, w in zip(got, want)]
            del got, want
            row["plan"] = ac.bwd_plan(B, N, N, D, bargs[0].dtype)
            phases["bwd"] = phase_ms(bwd)
        row["phase_ms"] = phases
        row["library_ms"] = library_ms(bargs, cuda_ms, reps)
        print(json.dumps(row), flush=True)
        del bargs, fwd, Q, V, keep


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout, timed as it is")
    ap.add_argument("--variants", nargs="+", default=["committed"],
                    choices=list(VARIANTS))
    ap.add_argument("--time", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--build", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        report_ptxas(*args.build, "contextual_attention_bwd", "wgmma_kernel")
        from sketchedit_tpu_torch.ops import _build
        log = _build.build_log.get("contextual_attention_bwd", "")
        notes = [ln.strip() for ln in log.splitlines()
                 if "serializ" in ln or "setmaxnreg" in ln]
        print(json.dumps({"ptxas_notes": args.build[1], "notes": notes}),
              flush=True)
        # a warp-specialised product compiled to fewer than 168 registers
        # at launch would leave its consumers' setmaxnreg.inc waiting on
        # registers the block does not hold: time nothing
        with open(os.path.join(args.build[0], WGMMA)) as fh:
            warp_spec = "struct WarpSpec" in fh.read()
        regs = re.findall(r"Compiling entry function '(\S*wgmma_kernel\S*)'"
                          r"[^\n]*\n(?:[^\n]*\n)*?[^\n]*Used (\d+) registers",
                          log)
        if warp_spec and (not regs or any(n != "168" for _, n in regs)):
            raise SystemExit(f"{args.build[1]}: product registers {regs}")
        return
    if args.time:
        return time_variant(*args.time)
    roots = {name: make(name, VARIANTS[name], BWD, ROOT, OUT)
             for name in args.variants}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    drive(__file__, roots)


if __name__ == "__main__":
    main()
