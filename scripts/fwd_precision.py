#!/usr/bin/env python3
"""How far the default and shared attention forwards, and their float32 plain
versions, are from the same function evaluated in float64, on one GPU.

    python3 scripts/fwd_precision.py [ROOT ...]

ROOT is a checkout whose sketchedit_tpu_torch is imported (this one by
default; an unpacked older checkout gives its kernels' errors on the same
inputs), each in its own process. Inputs as in tests/test_torch_kernels.py:
Q ~ N(0, 1/D), K and V ~ N(0, 1) for the default forward (a separate K, no
kscale); for the shared forward queries are unscaled rows of V and the keys
V * kscale with kscale ~ U(0.5, 1.5) / sqrt(D), so a key's similarity to
itself reaches a logit of ~10 sqrt(D). One JSON line per checkout, kernel,
shape and dtype: max |kernel - plain float32|, max |kernel - float64|, max
|plain float32 - float64|, the same for lse, the elements past
rtol = atol = 1e-4 against either reference, and the card's name and power
limit. Needs a GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("shared", (8, 961, 961, 1536), 0.6), ("shared", (9, 260, 260, 1536), 0.9),
         ("default", (8, 961, 961, 1536), 0.6), ("default", (3, 300, 200, 600), 0.9))


def measure(root: str):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from sketchedit_tpu_torch.ops import attention_cuda as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    def inputs(seed, B, N, P, D, keep_p, dtype):
        rs = np.random.RandomState(seed)
        Q, K, V = (torch.from_numpy((rs.randn(B, n, D) * s).astype(
            np.float32)).to(dev, dtype) for n, s in ((N, D ** -0.5),
                                                     (P, 1.0), (P, 1.0)))
        keep = torch.from_numpy((rs.rand(B, P) < keep_p).astype(np.float32))
        return Q, K, V, keep.to(dev)

    def exact(Q, K, V, keep, kscale):
        Kd = K.double() * (1.0 if kscale is None
                           else kscale.double()[:, None, :])
        logits = torch.bmm(Q.double(), Kd.transpose(1, 2))
        logits = logits * keep.double()[:, None, :] * 10.0
        return (torch.bmm(torch.softmax(logits, -1), V.double()),
                torch.logsumexp(logits, -1))

    def err(a, b):
        return (a.double() - b.double()).abs().max().item()

    def over(a, b):
        d = (a.double() - b.double()).abs()
        return int((d > 1e-4 + 1e-4 * b.double().abs()).sum().item())

    for kernel, shape, keep_p in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            Q, K, V, keep = inputs(sum(shape), *shape, keep_p, dtype)
            B, _, _, D = shape
            f32 = torch.float32
            if kernel == "shared":
                ks = ((torch.rand(B, D, generator=torch.Generator(
                    ).manual_seed(4)) + 0.5) * D ** -0.5).to(dev)
                out, lse = ac.attention_core_shared(V, ks, keep,
                                                    return_lse=True,
                                                    out_dtype=f32)
                p32, l32 = ac.attention_core_shared_reference(
                    V, ks, keep, return_lse=True, out_dtype=f32)
                p64, l64 = exact(V, V, V, keep, ks)
            else:
                out, lse = ac.attention_core(Q, K, V, keep, return_lse=True,
                                             out_dtype=f32)
                p32, l32 = ac.attention_core_reference(
                    Q, K, V, keep, return_lse=True, out_dtype=f32)
                p64, l64 = exact(Q, K, V, keep, None)
            torch.cuda.synchronize()
            print(json.dumps({
                "checkout": root, "kernel": kernel, "shape_BNPD": shape,
                "dtype": str(dtype).split(".")[-1],
                "kernel_vs_plain32": err(out, p32),
                "kernel_vs_float64": err(out, p64),
                "plain32_vs_float64": err(p32, p64),
                "lse_kernel_vs_float64": err(lse, l64),
                "lse_plain32_vs_float64": err(l32, l64),
                "past_tol_vs_plain32": over(out, p32),
                "past_tol_vs_float64": over(out, p64), "card": card}),
                flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        return measure(sys.argv[2])
    for root in sys.argv[1:] or [ROOT]:
        subprocess.run([sys.executable, __file__, "--measure",
                        os.path.abspath(root)], check=True)
    return None


if __name__ == "__main__":
    main()
