#!/usr/bin/env python3
"""Time the joint backward (dQ, dK and dV from one sequence) against the dQ
and fused dK/dV sequences it replaces, here and in an older checkout, on
one GPU, in one run, in turns.

    python3 scripts/bwd_variants.py [--parent DIR]

The harness is scripts/dsplit_variants.py's: the checkout as committed
(``committed``) and, with ``--parent DIR``, another checkout as it is (an
unpacked parent commit, ``parent``) each build their kernels, then each is
timed in its own process, in the order given and then in reverse
(committed, parent, parent, committed).

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
and its gradients through autograd on the same function, ``library_ms``)
and the card's name and power limit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dq_variants import digest, main_path_args  # noqa: E402
from dsplit_variants import ROOT, card, drive, make  # noqa: E402
from fwd_variants import host_ms  # noqa: E402

OUT = os.path.join(ROOT, "results", "bwd_variants")
BWD = os.path.join("sketchedit_tpu_torch", "csrc",
                   "contextual_attention_bwd.cu")
SHAPES = ((8, "float32"), (8, "bfloat16"), (1, "float32"), (1, "bfloat16"))
# profiler kernel name -> phase, first match
PHASES = (("_split_", "prep"), ("wgmma_kernel<64", "s_dp"),
          ("_weights", "weights"), ("ca_dkdv_wgmma_kernel<96", "dv_dk"),
          ("ca_dq_wgmma_kernel<96", "dq"))


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
        row = {"variant": name, "image_hw": [256, 256],
               "shape_BNPD": [B, N, N, D], "dtype": dtype, "card": card_,
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
        del bargs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout, timed as it is")
    ap.add_argument("--time", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--build", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        sys.path.insert(0, args.build[0])
        from sketchedit_tpu_torch.ops import _build
        _build.load()
        return
    if args.time:
        return time_variant(*args.time)
    roots = {"committed": make("committed", [], BWD, ROOT, OUT)}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    drive(__file__, roots)


if __name__ == "__main__":
    main()
