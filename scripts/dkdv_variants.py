#!/usr/bin/env python3
"""Time design choices of the fused dK/dV backward kernel against each other
on one GPU, in one run, in turns.

    python3 scripts/dkdv_variants.py [--variants committed rows8 ...]
        [--parent DIR] [--clocks]

The harness is scripts/dsplit_variants.py's: each variant is a copy of a
checkout's sketchedit_tpu_torch with a few textual edits to
csrc/contextual_attention_bwd.cu (an edit whose anchor is missing fails the
run; ``cvt`` edits csrc/contextual_attention_common.cuh instead) under
results/dkdv_variants/<name>/, where it builds its own kernels;
all build in parallel, then each is timed in its own process, in the order
given and then in reverse. ``--parent DIR`` (an unpacked older checkout,
whose fused kernel runs its tile products and accumulations on the CUDA
cores) adds it as the variant ``parent`` and is the base of
``parent_clocks``: with one variant, ``parent`` and it run ABBA. Variants:

  committed      the kernel as committed: a cluster of two blocks per key
                 tile, each contracting half of D and accumulating 768
                 columns, 96 a warp in registers; 16-key tiles, 8 where
                 16-key clusters would leave SMs idle and 8-key ones all fit
                 at once; every product split TF32 on the tensor cores; a
                 staging area a warp that holds two steps of each phase in
                 flight; S^T's partial put to shared memory before dP^T
                 runs; operands split on their bits; whole cluster barriers
  rows8          8-key clusters wherever 16-key ones leave SMs idle (at
                 256^2, B = 1: 242 blocks in two waves, not 122 in one)
  stages1        one step in flight in each phase (each step waits for its
                 own copies)
  stages3        three steps in flight in each phase (a larger area)
  cvt            operands split with cvt.rna.tf32.f32 (an edit to
                 to_tf32 in csrc/contextual_attention_common.cuh): the same
                 operands in seven instructions a split where the bit
                 rounding takes four
  clocks         the committed kernel with clock64() counters: thread 0's
                 cycles per query tile in the partial S^T product, the
                 partial dP^T product, writing the partials and the block
                 barrier, summing the eight partials, the exchange (the
                 sums to the peer and the first cluster barrier), the
                 weights (the peer's sums, P^T and dS^T, and the second
                 cluster barrier) and the accumulation of dV and dK_eff
                 (one loop, its first steps' copies included)
  parent_clocks  the parent's kernel with counters: cycles per query tile in
                 the partial S^T product, the partial dP^T product, writing
                 the partials and the first cluster barrier, reading the
                 peer's and forming P and dS up to the second barrier,
                 storing P^T and dS^T, and the dV and dK accumulations

``--clocks`` builds every variant chosen with the counters of ``clocks``
(or ``parent_clocks``) as ``<name>+clocks`` and times those instead.

One JSON line per variant, shape and dtype: the dK/dV kernel's ms (CUDA
events after warm-up), the largest |difference| from its plain version as
a share of each gradient's max, the launch plan where the checkout has
``dkdv_plan``, and the card's name and power limit; ``committed`` and
``parent`` also time the dV and dK kernels, whose sum the fused kernel
replaces (``pair_ms``); a `ptxas` line per dK/dV instantiation gives
registers and spills. Shapes as on the training path (chip_smoke.py's
inputs): 256^2 (B = 8 and 1), D = 1536, float32 and bfloat16, and 128^2
(B = 1), float32, where the rule takes 8-key tiles. Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dsplit_variants import ROOT, card, drive, make, report_ptxas  # noqa: E402

OUT = os.path.join(ROOT, "results", "dkdv_variants")
BWD = os.path.join("sketchedit_tpu_torch", "csrc",
                   "contextual_attention_bwd.cu")

CLOCK_READ = ("const char* sketchedit_cuda_error_string(int code) {",
              """int sketchedit_clock_read(unsigned long long* out) {
  const unsigned long long zero[16] = {0};
  int err = (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  return err ? err : (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));
}

const char* sketchedit_cuda_error_string(int code) {""")
CLOCK_DECL = ("namespace {\n",
              "namespace {\n__device__ unsigned long long g_clk[16];\n")
# anchors in the fused kernel: the store of this block's sums for the peer,
# the two cluster barriers, the end of the tile loop, the output stores, and
# the accumulation's steps (from its count to its first steps in flight)
XS_STORE = "    *reinterpret_cast<float4*>(xs + srow * kWLd + sq) = sx;\n"
SYNC1 = ("    cluster.sync();  // both blocks' sums are written; every partial "
         "is read\n")
SYNC2 = "    // barrier; and the weights are written.\n    cluster.sync();\n"
LOOP_END = ("    cp_wait<0>();\n    __syncwarp();\n  }\n\n"
            "  // each thread writes")
COMMON = os.path.join("sketchedit_tpu_torch", "csrc",
                      "contextual_attention_common.cuh")
# to_tf32's split rounded by cvt.rna.tf32.f32 instead of on the bits
CVT = [("""    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
""", """    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
""")]


CLOCKS = [
    CLOCK_DECL, CLOCK_READ,
    ("  const int cw = (blockIdx.y >> 1) * kSlab + rank * kHalfCols +\n",
     "  unsigned long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  const int cw = (blockIdx.y >> 1) * kSlab + rank * kHalfCols +\n"),
    ("    {\n      float s[kTq / 8][4];\n",
     "    const long long c0 = clock64();\n"
     "    {\n      float s[kTq / 8][4];\n"),
    ("      put(part, s);\n    }\n",
     "      put(part, s);\n    }\n    const long long c1 = clock64();\n"),
    ("      put(part + kRows * kQLd, dp);\n    }\n"
     "    __syncthreads();  // every partial is written\n",
     "      put(part + kRows * kQLd, dp);\n    }\n"
     "    const long long c2 = clock64();\n"
     "    __syncthreads();  // every partial is written\n"
     "    const long long c3 = clock64();\n"),
    (XS_STORE, "    const long long c4 = clock64();\n" + XS_STORE),
    (SYNC1, SYNC1 + "    const long long c5 = clock64();\n"),
    (SYNC2, SYNC2 + "    const long long c6 = clock64();\n"),
    (LOOP_END, """    cp_wait<0>();
    __syncwarp();
    ph[0] += c1 - c0; ph[1] += c2 - c1; ph[2] += c3 - c2; ph[3] += c4 - c3;
    ph[4] += c5 - c4; ph[5] += c6 - c5; ph[6] += clock64() - c6; ph[7] += 1;
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < 8; ++i) atomicAdd(&g_clk[i], ph[i]);

  // each thread writes"""),
]
CLOCK_PHASES = ("S", "dP", "partials_sync", "sum", "exchange", "weights",
                "accumulate")
# the parent's kernel (the two-block cluster on the CUDA cores)
PARENT_CLOCKS = [
    CLOCK_DECL, CLOCK_READ,
    ("""  for (int i0 = 0; i0 < N; i0 += kT) {
    // read after the barrier that ends the tile products; the previous
""", """  unsigned long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i0 = 0; i0 < N; i0 += kT) {
    // read after the barrier that ends the tile products; the previous
"""),
    ("""    float s[RPT][kCPT], dp[RPT][kCPT];
    tile_dot<T, T, R, 1, Tl::kDC>(Kb, j0, P, Qb, i0, N, ks_b, D, c_lo,
                                  c_lo + nc, as, bs, s);
    tile_dot<T, float, R, 0, Tl::kDC>(Vb, j0, P, dOb, i0, N, nullptr, D, c_lo,
                                      c_lo + nc, as, bs, dp);
""", """    float s[RPT][kCPT], dp[RPT][kCPT];
    const long long c0 = clock64();
    tile_dot<T, T, R, 1, Tl::kDC>(Kb, j0, P, Qb, i0, N, ks_b, D, c_lo,
                                  c_lo + nc, as, bs, s);
    const long long c1 = clock64();
    tile_dot<T, float, R, 0, Tl::kDC>(Vb, j0, P, dOb, i0, N, nullptr, D, c_lo,
                                      c_lo + nc, as, bs, dp);
    const long long c2 = clock64();
"""),
    ("""    cluster.sync();  // both blocks' partials are written
""", """    cluster.sync();  // both blocks' partials are written
    const long long c3 = clock64();
"""),
    ("""    cluster.sync();
    store_row(p_s + off, p);
    store_row(ds_s + off, ds);
    __syncthreads();
""", """    cluster.sync();
    const long long c4 = clock64();
    store_row(p_s + off, p);
    store_row(ds_s + off, ds);
    __syncthreads();
    const long long c5 = clock64();
"""),
    ("""          dv_acc, Dh, nc, dOb + row0, D, qn, p_s, nullptr);
""", """          dv_acc, Dh, nc, dOb + row0, D, qn, p_s, nullptr);
      const long long c6 = clock64();
      ph[5] += c6 - c5;
"""),
    ("""          dk_acc, Dh, nc, Qb + row0, D, qn, ds_s, nullptr);
    }
  }
""", """          dk_acc, Dh, nc, Qb + row0, D, qn, ds_s, nullptr);
      ph[6] += clock64() - c6;
    }
    ph[0] += c1 - c0; ph[1] += c2 - c1; ph[2] += c3 - c2; ph[3] += c4 - c3;
    ph[4] += c5 - c4; ph[7] += 1;
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < 8; ++i) atomicAdd(&g_clk[i], ph[i]);
"""),
]
PARENT_PHASES = ("S", "dP", "partials_sync", "peer_P_dS_sync", "store",
                 "acc_dV", "acc_dK")
# variant -> (base: this checkout or --parent, edits to csrc/..._bwd.cu)
VARIANTS = {
    "committed": ("self", []),
    "rows8": ("self", [(
        "blocks(kRows) >= sm_count() || blocks(8) > sm_count() ? kRows : 8",
        "blocks(kRows) >= sm_count() ? kRows : 8")]),
    **{f"stages{n}": ("self", [("constexpr int kDkdvStages = 2;",
                                 f"constexpr int kDkdvStages = {n};")])
       for n in (1, 3)},
    "cvt": ("self", []),
    "clocks": ("self", CLOCKS),
    "parent_clocks": ("parent", PARENT_CLOCKS),
}
SHAPES = ((8, 64, "float32"), (8, 64, "bfloat16"), (1, 64, "float32"),
          (1, 64, "bfloat16"), (1, 32, "float32"))


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
    for B, hw, dtype in SHAPES:
        f = features(rs, B, hw, hw).cuda().to(getattr(torch, dtype))
        Q, V, keep, ksc = ac.attention_inputs(f, f, hole_mask(B, hw, hw).cuda())
        out, lse = ac.attention_core(Q, V, V, keep, return_lse=True,
                                     out_dtype=torch.float32, kscale=ksc)
        dO = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            0)).cuda()
        bargs = (Q, V, V, keep, lse, (dO * out).sum(-1), dO, 10.0, ksc)
        B, N, D = Q.shape
        reps = 10 if B > 1 else 20
        row = {"variant": name, "image_hw": [4 * hw, 4 * hw],
               "shape_BNPD": [B, N, N, D], "dtype": dtype, "card": card_,
               "dkdv_ms": cuda_ms(lambda: ac.attention_core_dkdv(*bargs),
                                  reps)}
        if name in ("committed", "parent"):
            row["pair_ms"] = cuda_ms(lambda: (
                ac.attention_core_dv(Q, V, keep, lse, dO, 10.0, ksc),
                ac.attention_core_dk(*bargs)), reps)
        got = ac.attention_core_dkdv(*bargs)
        want = ac.attention_core_dkdv_reference(*bargs)
        row["max_abs_err_rel"] = max(
            ((g - w).abs().max() / w.abs().max().clamp_min(1e-6)).item()
            for g, w in zip(got, want))
        if hasattr(ac, "dkdv_plan"):
            row["plan"] = ac.dkdv_plan(B, N, N, D, Q.dtype)
        if "clocks" in name:
            phases = PARENT_PHASES if name.startswith("parent") \
                else CLOCK_PHASES
            read = _build.load()["contextual_attention_bwd"
                                 ].sketchedit_clock_read
            read.argtypes = [ctypes.c_void_p]
            clk = (ctypes.c_ulonglong * 16)()
            torch.cuda.synchronize()
            assert read(ctypes.addressof(clk)) == 0      # zeroes them
            ac.attention_core_dkdv(*bargs)
            torch.cuda.synchronize()
            assert read(ctypes.addressof(clk)) == 0
            row["cycles_per_tile"] = {k: clk[i] / clk[7]
                                      for i, k in enumerate(phases)}
        print(json.dumps(row), flush=True)
        del f, Q, V, out, dO, bargs, got, want


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--parent", help="another checkout, timed as it is and "
                                     "the base of parent_clocks")
    ap.add_argument("--clocks", action="store_true",
                    help="time every variant with clock64() counters")
    ap.add_argument("--build", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--time", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        return report_ptxas(*args.build, "contextual_attention_bwd",
                            "dkdv_kernel")
    if args.time:
        return time_variant(*args.time)
    parent = args.parent and os.path.abspath(args.parent)
    names = [n for n in args.variants
             if VARIANTS[n][0] == "self" or parent]
    if len(names) < len(args.variants):
        print("dkdv_variants: parent_* variants need --parent; skipped",
              file=sys.stderr)
    roots = {}
    if parent and args.clocks:
        roots["parent+clocks"] = make("parent+clocks", PARENT_CLOCKS, BWD,
                                      parent, OUT)
    elif parent:
        roots["parent"] = parent
    for name in names:
        base, edits = VARIANTS[name]
        if args.clocks and "clocks" not in name:
            edits = (PARENT_CLOCKS if base == "parent" else CLOCKS) + edits
            name += "+clocks"
        roots[name] = make(name, edits, BWD, parent if base == "parent"
                           else ROOT, OUT)
        if name.split("+")[0] == "cvt":
            edit_source(roots[name], COMMON, CVT)
    drive(__file__, roots)


if __name__ == "__main__":
    main()
