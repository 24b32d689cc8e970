#!/usr/bin/env python3
"""Time design choices of the split-TF32 dQ backward kernel against each
other, and against an older checkout, on one GPU, in one run, in turns.

    python3 scripts/dq_variants.py [--variants committed rows16 ...]
        [--parent DIR] [--clocks]

The harness is scripts/dsplit_variants.py's: each variant is a copy of this
checkout's sketchedit_tpu_torch with a few textual edits to
csrc/contextual_attention_bwd.cu (an edit whose anchor is missing fails the
run) under results/dq_variants/<name>/, where it builds its own kernels;
all build in parallel, then each is timed in its own process, in the order
given and then in reverse. ``--parent DIR`` adds another checkout as it is
(an unpacked parent commit, whose dQ kernel runs on the CUDA cores) as the
variant ``parent``. ``--clocks`` adds ``clocks``. Variants:

  committed  the kernel as committed: 16-row blocks, 8-row ones where
             16-row blocks would leave SMs idle; D split over the warps for
             S and dP, one set of K fragments for both where V is K; a
             12.8 KB staging area a warp
  rows16     16-row blocks everywhere
  rows8      8-row blocks everywhere (the lower half of every A tile zero)
  split      K and V staged and converted apart even where they are one
             tensor (the build that separate K and V take): one step in
             flight in float32, two in bfloat16
  deep       a 15 KB staging area a warp: three steps of S and dP in
             flight in float32 (five in bfloat16), three and four of dS K;
             the block then takes 226,688 bytes, so D is limited to 1536
  nofence    no compiler fence before each n8 tile's (S, dP) or 32-column
             group's (dS K) fragment loads, so the compiler may load them
             ahead of the previous tile's mma, at the cost of registers
  clocks     the committed kernel with clock64() counters read back after
             one call: thread 0's cycles per key tile in the S and dP
             products (one loop: they share their K fragments) with the
             partial stores, the barrier after them, the dS formation, the
             barrier after it, and dS K

One JSON line per variant, shape and dtype: dQ's ms (CUDA events after
warm-up, the main path's call: Q = K = V one tensor, kscale, float32 dO),
its largest |difference| from the plain version as a share of max |dQ|,
the launch plan where the checkout has ``dq_plan``, and the card's name and
power limit. ``committed`` and ``parent`` also time the other six kernels
at every shape: the default, shared and D-split forwards (float32 output,
as on the main path), the fused dK/dV, dV and dK. A `ptxas` line per dQ
instantiation gives registers and spills. Shapes as on the training path
(chip_smoke.py's inputs): 256^2, B = 1 and 8, D = 1536, float32 and
bfloat16. Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dsplit_variants import ROOT, card, drive, make, report_ptxas  # noqa: E402

OUT = os.path.join(ROOT, "results", "dq_variants")
BWD = os.path.join("sketchedit_tpu_torch", "csrc",
                   "contextual_attention_bwd.cu")

ROWS = ("  const int rows =\n      (long long)a.B * ((a.N + kRows - 1) / kRows)"
        " < sm_count() ? 8 : kRows;")
CLOCKS = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_clk[16];\n"),
    ("""  for (int k0 = 0; k0 < P; k0 += kT) {
    const int kn = min(kT, P - k0);              // real keys of the tile
""", """  unsigned long long ph[6] = {0, 0, 0, 0, 0, 0};
  for (int k0 = 0; k0 < P; k0 += kT) {
    const long long c0 = clock64();
    const int kn = min(kT, P - k0);              // real keys of the tile
"""),
    ("""    __syncthreads();  // every partial is written
""", """    const long long c1 = clock64();
    __syncthreads();  // every partial is written
    const long long c2 = clock64();
"""),
    ("""    __syncthreads();  // dS is written; the partials are read
""", """    const long long c3 = clock64();
    __syncthreads();  // dS is written; the partials are read
    const long long c4 = clock64();
"""),
    ("""    cp_wait<0>();
  }

  // dQ = acc * kscale; each thread writes the columns it accumulated
""", """    cp_wait<0>();
    ph[0] += c1 - c0; ph[1] += c2 - c1; ph[2] += c3 - c2; ph[3] += c4 - c3;
    ph[4] += clock64() - c4; ph[5] += 1;
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < 6; ++i) atomicAdd(&g_clk[i], ph[i]);

  // dQ = acc * kscale; each thread writes the columns it accumulated
"""),
    ("const char* sketchedit_cuda_error_string(int code) {",
     """int sketchedit_clock_read(unsigned long long* out) {
  const unsigned long long zero[16] = {0};
  int err = (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  return err ? err : (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));
}

const char* sketchedit_cuda_error_string(int code) {"""),
]
CLOCK_PHASES = ("S_dP", "sync", "dS", "dS_sync", "dSK")
VARIANTS = {
    "committed": [],
    "rows16": [(ROWS, "  const int rows = kRows;")],
    "rows8": [(ROWS, "  const int rows = 8;")],
    "split": [("  const bool same = a.k == a.v;",
               "  const bool same = false;")],
    "deep": [("constexpr int kDqArea = 12800;",
              "constexpr int kDqArea = 15360;")],
    "clocks": CLOCKS,
    "nofence": [
        ("        fence();\n        const float4 kf = lds4(",
         "        const float4 kf = lds4("),
        ("        fence();\n        const float4 ka = lds4(",
         "        const float4 ka = lds4("),
    ],
}
SHAPES = ((1, "float32"), (8, "float32"), (1, "bfloat16"), (8, "bfloat16"))


def time_variant(root: str, name: str):
    sys.path[:0] = [root, ROOT]
    import numpy as np
    import torch

    from chip_smoke import cuda_ms, features, hole_mask
    from sketchedit_tpu_torch.ops import _build
    from sketchedit_tpu_torch.ops import attention_cuda as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    card_ = card()
    rs = np.random.RandomState(0)
    f32 = torch.float32
    others = name in ("committed", "parent")
    for B, dtype in SHAPES:
        f = features(rs, B, 64, 64).cuda().to(getattr(torch, dtype))
        Q, V, keep, ksc = ac.attention_inputs(f, f, hole_mask(B, 64, 64).cuda())
        B, N, D = Q.shape
        out, lse = ac.attention_core(Q, V, V, keep, return_lse=True,
                                     out_dtype=f32, kscale=ksc)
        dO = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            0)).cuda()
        bargs = (Q, V, V, keep, lse, (dO * out).sum(-1), dO, 10.0, ksc)
        dq = lambda: ac.attention_core_dq(*bargs)
        row = {"variant": name, "image_hw": [256, 256],
               "shape_BNPD": [B, N, N, D], "dtype": dtype, "card": card_,
               "dq_ms": cuda_ms(dq, 10, warmup=1)}
        want = ac.attention_core_dq_reference(*bargs)
        row["dq_max_abs_err_rel"] = ((dq() - want).abs().max()
                                     / want.abs().max()).item()
        del want
        if hasattr(ac, "dq_plan"):
            row["plan"] = ac.dq_plan(B, N, N, D, Q.dtype)
        if others:
            row["fwd_ms"] = cuda_ms(lambda: ac.attention_core(
                Q, V, V, keep, out_dtype=f32, kscale=ksc), 10, warmup=1)
            row["shared_ms"] = cuda_ms(lambda: ac.attention_core_shared(
                V, ksc, keep, out_dtype=f32), 10, warmup=1)
            row["dsplit_ms"] = cuda_ms(lambda: ac.attention_core_dsplit(
                Q, V, V, keep, out_dtype=f32, kscale=ksc), 10, warmup=1)
            row["dkdv_ms"] = cuda_ms(lambda: ac.attention_core_dkdv(*bargs),
                                     10, warmup=1)
            row["dv_ms"] = cuda_ms(lambda: ac.attention_core_dv(
                Q, V, keep, lse, dO, 10.0, ksc), 10, warmup=1)
            row["dk_ms"] = cuda_ms(lambda: ac.attention_core_dk(*bargs), 10,
                                   warmup=1)
        if "clocks" in name:
            read = _build.load()["contextual_attention_bwd"
                                 ].sketchedit_clock_read
            read.argtypes = [ctypes.c_void_p]
            clk = (ctypes.c_ulonglong * 16)()
            torch.cuda.synchronize()
            assert read(ctypes.addressof(clk)) == 0      # zeroes them
            dq()
            torch.cuda.synchronize()
            assert read(ctypes.addressof(clk)) == 0
            tiles = clk[len(CLOCK_PHASES)]
            row["dq_cycles_per_tile"] = {
                k: clk[i] / tiles for i, k in enumerate(CLOCK_PHASES)}
        print(json.dumps(row), flush=True)
        del f, Q, V, out, lse, dO, bargs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+",
                    default=["committed", "rows16", "rows8", "split", "deep"],
                    choices=list(VARIANTS))
    ap.add_argument("--parent", help="another checkout, timed as it is")
    ap.add_argument("--clocks", action="store_true",
                    help="add the clocks variant")
    ap.add_argument("--build", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--time", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        return report_ptxas(*args.build, "contextual_attention_bwd",
                            "ca_dq_kernel")
    if args.time:
        return time_variant(*args.time)
    names = list(dict.fromkeys(args.variants + ["clocks"] * args.clocks))
    roots = {name: make(name, VARIANTS[name], BWD, ROOT, OUT)
             for name in names}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    drive(__file__, roots)


if __name__ == "__main__":
    main()
