#!/usr/bin/env python3
"""Time the tensor-core attention kernels with their split-TF32 operands
rounded on the bits (``to_tf32`` as committed) against the same split by
``cvt.rna.tf32.f32``, on one GPU, in one run, in turns.

    python3 scripts/tf32_split_ab.py

Two copies of sketchedit_tpu_torch under results/tf32_split_ab/: ``bits``
as committed and ``cvt``, whose ``to_tf32`` rounds with cvt.rna
(scripts/dkdv_variants.py's ``CVT`` edit). Both build in parallel, then
each is timed in its own process: bits, cvt, cvt, bits. One JSON line per
copy, batch and dtype at 256^2 (B = 1 and 8, D = 1536, chip_smoke.py's
inputs): ms by CUDA events after warm-up of the default and shared
forwards (float32 output, as on the main path), dQ, dV, dK and the fused
dK/dV (the wgmma forwards, dQ and the fused dK/dV split their operands in
their own prep kernels, not with ``to_tf32``, so they are the same code in
both copies); a digest of each kernel's output, which must be the same in both
copies, since the two roundings give the same operands; and the card's
name and power limit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dkdv_variants import BWD, COMMON, CVT, edit_source  # noqa: E402
from dsplit_variants import ROOT, card, drive, make  # noqa: E402

OUT = os.path.join(ROOT, "results", "tf32_split_ab")


def digest(res) -> str:
    import torch
    res = res if isinstance(res, tuple) else (res,)
    flat = torch.cat([t.float().flatten() for t in res]).cpu().numpy()
    return hashlib.sha1(flat.tobytes()).hexdigest()[:16]


def build(root: str):
    sys.path.insert(0, root)
    from sketchedit_tpu_torch.ops import _build
    _build.load()


def time_copy(root: str, name: str):
    sys.path[:0] = [root, ROOT]
    import numpy as np
    import torch

    from chip_smoke import cuda_ms, features, hole_mask
    from sketchedit_tpu_torch.ops import attention_cuda as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    card_ = card()
    rs = np.random.RandomState(0)
    f32 = torch.float32
    for B in (1, 8):
        for dtype in (torch.float32, torch.bfloat16):
            f = features(rs, B, 64, 64).cuda().to(dtype)
            Q, V, keep, ksc = ac.attention_inputs(
                f, f, hole_mask(B, 64, 64).cuda())
            out, lse = ac.attention_core(Q, V, V, keep, return_lse=True,
                                         out_dtype=f32, kscale=ksc)
            dO = torch.randn(out.shape, generator=torch.Generator(
            ).manual_seed(0)).cuda()
            bargs = (Q, V, V, keep, lse, (dO * out).sum(-1), dO, 10.0, ksc)
            calls = {
                "fwd": lambda: ac.attention_core(Q, V, V, keep, out_dtype=f32,
                                                 kscale=ksc),
                "shared": lambda: ac.attention_core_shared(V, ksc, keep,
                                                           out_dtype=f32),
                "dq": lambda: ac.attention_core_dq(*bargs),
                "dv": lambda: ac.attention_core_dv(Q, V, keep, lse, dO, 10.0,
                                                   ksc),
                "dk": lambda: ac.attention_core_dk(*bargs),
                "dkdv": lambda: ac.attention_core_dkdv(*bargs),
            }
            B_, N, D = Q.shape
            row = {"copy": name, "image_hw": [256, 256],
                   "shape_BNPD": [B_, N, V.shape[1], D],
                   "dtype": str(dtype).split(".")[-1], "card": card_}
            for k, fn in calls.items():
                row[f"{k}_ms"] = cuda_ms(fn, 10 if B > 1 else 20)
                row[f"{k}_digest"] = digest(fn())
            print(json.dumps(row), flush=True)
            del f, Q, V, keep, ksc, out, lse, dO, bargs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--build", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--time", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        return build(args.build[0])
    if args.time:
        return time_copy(*args.time)
    roots = {name: make(name, [], BWD, ROOT, OUT) for name in ("bits", "cvt")}
    edit_source(roots["cvt"], COMMON, CVT)
    drive(__file__, roots)


if __name__ == "__main__":
    main()
