#!/usr/bin/env python3
"""Time dV and dK alone (the backward sequence run with a mask of one
product) here and in an older checkout, on one GPU, in one run, in turns.

    python3 scripts/dk_dv_variants.py [--parent DIR]
    python3 scripts/dk_dv_variants.py --precision

The harness is scripts/dsplit_variants.py's, as in scripts/bwd_variants.py:
the checkout as committed (``committed``) and, with ``--parent DIR``,
another checkout as it is (an unpacked parent commit, ``parent``) each
build their kernels, then each is timed in its own process, in the order
given and then in reverse (committed, parent, parent, committed).

One JSON line per checkout, shape and dtype, at the main path's call (Q =
K = V one tensor, kscale, float32 dO; chip_smoke.py's inputs at 256^2, B =
8 and 1, D = 1536, float32 and bfloat16): the ms (CUDA events after
warm-up) of dV and dK alone (``dv_ms``, ``dk_ms``), of the
SKETCHEDIT_SPLIT_DKDV route (dQ, dV and dK one after the other,
``split_ms``) and of the joint backward (``bwd_ms``, where the checkout has
it), each one's host ms per call (the enqueue alone), the device time of
each phase of one dV and one dK call from torch.profiler (``phase_ms``:
the split copies, S and dP, the weights, the product; a parent's
single-kernel dV and dK under ``mma_sync``), a digest of each output and of
the joint's dV and dK_eff (``dv_digest`` equals ``bwd_dv_digest`` where the
bits agree), their largest |difference| from the plain versions as a share
of the largest value, the launch plans (``dk_dv_plan``), the library's
backward (``F.scaled_dot_product_attention`` and its three gradients
through autograd on the same function, ``library_ms``) and the card's name
and power limit. Needs a GPU.

``--precision`` times nothing: at the main path's one-tensor call (256^2,
B = 1 and 8, and a ragged 29^2, B = 3) it prints, per dtype, the largest
|difference| of dV and dK alone, the fused dK/dV and the plain versions (on
the card and on the CPU) from a float64 evaluation of the same function on
the same inputs (the forward kernel's lse and delta), as a share of its
largest value, and the largest logit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bwd_variants import PHASES, library_ms, phase_ms  # noqa: E402
from dq_variants import digest  # noqa: E402
from dq_variants import main_path_args as main_path_call  # noqa: E402
from dsplit_variants import ROOT, card, drive, make  # noqa: E402
from fwd_variants import host_ms  # noqa: E402

OUT = os.path.join(ROOT, "results", "dk_dv_variants")
BWD = os.path.join("sketchedit_tpu_torch", "csrc",
                   "contextual_attention_bwd.cu")
SHAPES = ((8, "float32"), (8, "bfloat16"), (1, "float32"), (1, "bfloat16"))
# an older checkout's dV and dK ran one mma.sync kernel each
ALONE_PHASES = PHASES + (("ca_dk_or_dv_kernel", "mma_sync"),)


def main_path_args(ac, torch, B, H, dtype, seed=0):
    """The backward's arguments as the training path makes them at H^2
    features: chip_smoke.py's features and hole mask, Q = K = V one tensor
    from ``attention_inputs``, a seeded float32 dO, the forward kernel's lse
    and delta."""
    import numpy as np

    from chip_smoke import features, hole_mask
    rs = np.random.RandomState(seed)
    f = features(rs, B, H, H).cuda().to(dtype)
    Q, V, keep, ksc = ac.attention_inputs(f, f, hole_mask(B, H, H).cuda())
    out, lse = ac.attention_core(Q, V, V, keep, return_lse=True,
                                 out_dtype=torch.float32, kscale=ksc)
    dO = torch.randn(out.shape, generator=torch.Generator().manual_seed(
        seed)).cuda()
    return (Q, V, V, keep, lse, (dO * out).sum(-1), dO, 10.0, ksc)


def time_variant(root: str, name: str):
    sys.path[:0] = [root, ROOT]
    import numpy as np
    import torch

    from chip_smoke import cuda_ms
    from sketchedit_tpu_torch.ops import attention_cuda as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    card_ = card()
    rs = np.random.RandomState(0)
    for B, dtype in SHAPES:
        bargs = main_path_call(ac, rs, B, getattr(torch, dtype))
        Q, K, V, keep, lse, _, dO, _, ksc = bargs
        N, D = Q.shape[1:]
        reps = 10 if B > 1 else 20
        dv = lambda: ac.attention_core_dv(Q, K, keep, lse, dO, 10.0, ksc)
        dk = lambda: ac.attention_core_dk(*bargs)
        dq = lambda: ac.attention_core_dq(*bargs)
        split = lambda: (dq(), dk(), dv())
        row = {"variant": name, "image_hw": [256, 256],
               "shape_BNPD": [B, N, N, D], "dtype": dtype, "card": card_,
               "dv_ms": cuda_ms(dv, reps), "dk_ms": cuda_ms(dk, reps),
               "split_ms": cuda_ms(split, reps),
               "dv_host_ms": host_ms(dv), "dk_host_ms": host_ms(dk)}
        got = {"dv": dv(), "dk": dk()}
        row["dv_digest"] = digest([got["dv"]])
        row["dk_digest"] = digest([got["dk"]])
        for k, want in (("dv", ac.attention_core_dv_reference(
                             Q, K, keep, lse, dO, 10.0, ksc)),
                        ("dk", ac.attention_core_dk_reference(*bargs))):
            row[f"{k}_max_abs_err_rel"] = ((got[k] - want).abs().max()
                                           / want.abs().max()).item()
        del got
        if hasattr(ac, "attention_core_bwd_joint"):
            bwd = lambda: ac.attention_core_bwd_joint(*bargs)
            row["bwd_ms"] = cuda_ms(bwd, reps)
            _, jk, jv = bwd()
            row["bwd_dv_digest"] = digest([jv])
            row["bwd_dk_digest"] = digest([jk])
            row["split_x_bwd"] = row["split_ms"] / row["bwd_ms"]
            del jk, jv
        row["plan"] = {k: ac.dk_dv_plan(B, N, N, D, Q.dtype, dk=k == "dk")
                       for k in ("dv", "dk")}
        row["phase_ms"] = {"dv": phase_ms(dv, ALONE_PHASES),
                           "dk": phase_ms(dk, ALONE_PHASES)}
        row["library_ms"] = library_ms(bargs, cuda_ms, reps)
        row["split_x_library"] = row["split_ms"] / row["library_ms"]
        print(json.dumps(row), flush=True)
        del bargs, Q, K, V, dO


def precision():
    sys.path.insert(0, ROOT)
    import torch

    from sketchedit_tpu_torch.ops import attention_cuda as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    card_ = card()
    for B, H in ((1, 64), (8, 64), (3, 29)):
        for dtype in (torch.float32, torch.bfloat16):
            args = main_path_args(ac, torch, B, H, dtype, seed=B * 100 + H)
            Q, K, V, keep, lse, delta, dO, _, ks = args
            cpu = [t.cpu() if torch.is_tensor(t) else t for t in args]
            Qc, Kc, _, keep_c, lse_c, _, dO_c, _, ks_c = cpu
            # float64 evaluation of the same function on the same inputs
            Kd = K.double() * ks.double()[:, None, :]
            g = keep.double()[:, None, :] * 10.0
            S = torch.bmm(Q.double(), Kd.transpose(1, 2))
            P = torch.exp(S * g - lse.double()[..., None])
            dP = torch.bmm(dO.double(), V.double().transpose(1, 2))
            dS = P * (dP - delta.double()[..., None]) * g
            truth = {"dV": torch.bmm(P.transpose(1, 2), dO.double()),
                     "dK_eff": torch.bmm(dS.transpose(1, 2), Q.double())}
            fused = ac.attention_core_dkdv(*args)
            got = {
                "dV": {"alone": ac.attention_core_dv(
                           Q, K, keep, lse, dO, 10.0, ks),
                       "fused": fused[1],
                       "plain_gpu": ac.attention_core_dv_reference(
                           Q, K, keep, lse, dO, 10.0, ks),
                       "plain_cpu": ac.attention_core_dv_reference(
                           Qc, Kc, keep_c, lse_c, dO_c, 10.0, ks_c)},
                "dK_eff": {"alone": ac.attention_core_dk(*args),
                           "fused": fused[0],
                           "plain_gpu": ac.attention_core_dk_reference(*args),
                           "plain_cpu": ac.attention_core_dk_reference(*cpu)}}
            row = {"precision": [B, H], "dtype": str(dtype).split(".")[-1],
                   "max_logit": (S * g).max().item(), "card": card_}
            for name, outs in got.items():
                want = truth[name].cpu()
                scale = want.abs().max().item()
                row[name] = {k: (v.double().cpu() - want).abs().max().item()
                             / scale for k, v in outs.items()}
            print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another checkout, timed as it is")
    ap.add_argument("--precision", action="store_true",
                    help="distances from float64 instead of times")
    ap.add_argument("--build", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--time", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.precision:
        return precision()
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
