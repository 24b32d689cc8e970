#!/usr/bin/env python3
"""Time design choices of the split-TF32 default and shared attention
forwards against each other, and against an older checkout, on one GPU, in
one run, in turns.

    python3 scripts/fwd_variants.py [--variants committed rows16 ...]
        [--parent DIR] [--clocks]

The harness is scripts/dsplit_variants.py's: each variant is a copy of this
checkout's sketchedit_tpu_torch with a few textual edits to
csrc/contextual_attention_fwd.cu (an edit whose anchor is missing fails the
run) under results/fwd_variants/<name>/, where it builds its own kernels;
all build in parallel, then each is timed in its own process, in the order
given and then in reverse. ``--parent DIR`` adds another checkout as it is
(an unpacked parent commit, whose forwards run on the CUDA cores) as the
variant ``parent``. ``--clocks`` adds ``clocks``. Variants:

  committed  the kernels as committed: 16-row blocks, 8-row ones where
             16-row blocks would leave SMs idle
  rows16     16-row blocks everywhere
  rows8      8-row blocks everywhere (the lower half of every mma's A
             tile zero)
  stagger    each block walks the key tiles from its own starting tile
             (query tile index mod tiles), so the blocks of an image do
             not all read the same K and V lines at once
  clocks     the committed kernels with clock64() counters read back after
             one call of the default forward: thread 0's cycles per key
             tile in the partial S (tensor-core product and partial
             store), the barrier after it, the partial-S sum, the softmax
             with the barrier after it, and P V

One JSON line per variant, shape and dtype: the default and shared
forwards' ms (CUDA events after warm-up, float32 output as on the main
path), the largest |difference| of each from the plain version, the launch
plan where the checkout has ``fwd_plan``, and the card's name and power
limit. ``committed`` and ``parent`` also time the other five kernels: the
D-split forward at every shape and, at 256^2, B = 8 (the training shape),
dQ, the fused dK/dV, dV and dK. A `ptxas` line per forward instantiation
gives registers and spills. Shapes as on the main path (chip_smoke.py's
inputs): 256^2 (B = 1 and 8) and 512^2, D = 1536, float32 and bfloat16.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dsplit_variants import ROOT, card, drive, make, report_ptxas  # noqa: E402

OUT = os.path.join(ROOT, "results", "fwd_variants")
FWD = os.path.join("sketchedit_tpu_torch", "csrc", "contextual_attention_fwd.cu")

ROWS = "  const int rows = blocks(kRows) < sm_count() ? 8 : kRows;"
CLOCKS = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_clk[16];\n"),
    ("""  for (int k0 = 0; k0 < P; k0 += kT) {
    // 1. this warp's partial S""", """  unsigned long long ph[6] = {0, 0, 0, 0, 0, 0};
  for (int k0 = 0; k0 < P; k0 += kT) {
    const long long c0 = clock64();
    // 1. this warp's partial S"""),
    ("""    __syncthreads();  // every partial is written
""", """    const long long c1 = clock64();
    __syncthreads();  // every partial is written
    const long long c2 = clock64();
    long long c3 = c2;
"""),
    ("""      float logit[4];
      float mx = -INFINITY;""", """      c3 = clock64();
      float logit[4];
      float mx = -INFINITY;"""),
    ("""    __syncthreads();  // P and alpha are written; the partials are read
""", """    __syncthreads();  // P and alpha are written; the partials are read
    const long long c4 = clock64();
"""),
    ("""    cp_wait<0>();
  }

  // O = acc / l; lse from the first slab
""", """    cp_wait<0>();
    ph[0] += c1 - c0; ph[1] += c2 - c1; ph[2] += c3 - c2; ph[3] += c4 - c3;
    ph[4] += clock64() - c4; ph[5] += 1;
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < 6; ++i) atomicAdd(&g_clk[i], ph[i]);

  // O = acc / l; lse from the first slab
"""),
    ("const char* sketchedit_cuda_error_string(int code) {",
     """int sketchedit_clock_read(unsigned long long* out) {
  const unsigned long long zero[16] = {0};
  int err = (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  return err ? err : (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));
}

const char* sketchedit_cuda_error_string(int code) {"""),
]
CLOCK_PHASES = ("S", "sync", "partial_sum", "softmax_sync", "PV")
STAGGER = ("""  for (int k0 = 0; k0 < P; k0 += kT) {
    // 1. this warp's partial S""", """  const int ntiles = (P + kT - 1) / kT;
  for (int it = 0; it < ntiles; ++it) {
    const int k0 = ((it + blockIdx.x) % ntiles) * kT;
    // 1. this warp's partial S""")
VARIANTS = {
    "committed": [],
    "rows16": [(ROWS, "  const int rows = kRows;")],
    "rows8": [(ROWS, "  const int rows = 8;")],
    "clocks": CLOCKS,
    "stagger": [STAGGER],
}
SHAPES = ((1, 64, "float32"), (8, 64, "float32"), (1, 128, "float32"),
          (1, 64, "bfloat16"), (8, 64, "bfloat16"), (1, 128, "bfloat16"))


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
    for B, hw, dtype in SHAPES:
        f = features(rs, B, hw, hw).cuda().to(getattr(torch, dtype))
        Q, V, keep, ksc = ac.attention_inputs(f, f, hole_mask(B, hw, hw).cuda())
        B, N, D = Q.shape
        reps = 10 if hw == 64 else 5
        fwd = lambda: ac.attention_core(Q, V, V, keep, out_dtype=f32,
                                        kscale=ksc)
        shared = lambda: ac.attention_core_shared(V, ksc, keep, out_dtype=f32)
        row = {"variant": name, "image_hw": [4 * hw, 4 * hw],
               "shape_BNPD": [B, N, N, D], "dtype": dtype, "card": card_,
               "fwd_ms": cuda_ms(fwd, reps, warmup=1),
               "shared_ms": cuda_ms(shared, reps, warmup=1)}
        want = ac.attention_core_reference(Q, V, V, keep, out_dtype=f32,
                                           kscale=ksc)
        row["fwd_max_abs_err"] = (fwd() - want).abs().max().item()
        row["shared_max_abs_err"] = (shared() - want).abs().max().item()
        del want
        if hasattr(ac, "fwd_plan"):
            row["plan"] = ac.fwd_plan(B, N, N, D, Q.dtype)
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
        if "clocks" in name:
            read = _build.load()["contextual_attention_fwd"
                                 ].sketchedit_clock_read
            read.argtypes = [ctypes.c_void_p]
            clk = (ctypes.c_ulonglong * 16)()
            torch.cuda.synchronize()
            assert read(ctypes.addressof(clk)) == 0      # zeroes them
            fwd()
            torch.cuda.synchronize()
            assert read(ctypes.addressof(clk)) == 0
            tiles = clk[len(CLOCK_PHASES)]
            row["fwd_cycles_per_tile"] = {
                k: clk[i] / tiles for i, k in enumerate(CLOCK_PHASES)}
        print(json.dumps(row), flush=True)
        del f, Q, V


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+",
                    default=["committed", "rows16", "rows8"],
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
        for kernel in ("ca_fwd_kernel", "ca_fwd_shared_kernel"):
            report_ptxas(*args.build, "contextual_attention_fwd", kernel)
        return None
    if args.time:
        return time_variant(*args.time)
    names = list(dict.fromkeys(args.variants + ["clocks"] * args.clocks))
    roots = {name: make(name, VARIANTS[name], FWD, ROOT, OUT)
             for name in names}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    drive(__file__, roots)


if __name__ == "__main__":
    main()
