#!/usr/bin/env python3
"""Time design choices of the fused dK/dV backward kernel against each other
on one GPU, in one run, in turns.

    python3 scripts/dkdv_variants.py [--variants committed unroll2 ...]
        [--parent DIR] [--clocks]

The harness is scripts/dsplit_variants.py's: each variant is a copy of a
checkout's sketchedit_tpu_torch with a few textual edits to
csrc/contextual_attention_bwd.cu (an edit whose anchor is missing fails the
run) under results/dkdv_variants/<name>/, where it builds its own kernels;
all build in parallel, then each is timed in its own process, in the order
given and then in reverse. ``--parent DIR`` (an unpacked older checkout,
whose fused kernel is one full-D block of 16 keys) adds it as the variant
``parent`` and is the base of the ``parent_*`` variants. Variants:

  committed      the kernel as committed: a cluster of two blocks per key
                 tile, each owning half of D; 32-key tiles where their
                 clusters fill the SMs; 64-wide D-chunks, staged where P^T
                 and dS^T go later; the accumulation 3 columns a thread,
                 unrolled 8 rows deep; P^T and dS^T rows padded to R + 4
                 floats
  chunk32        32-wide D-chunks (the cluster kernel as first written)
  unroll2        the accumulation unrolled 2 deep (the shared rule's depth)
  unroll4        4 deep
  nc1            1 column a thread in the accumulation (3 passes a half)
  nc2            2 columns a thread (2 passes, the second half empty)
  nopad          P^T and dS^T rows unpadded (R floats)
  scaleq         kscale on the staged Q rows in the S^T product (64 values
                 a chunk), not on the staged K rows (R)
  rows16         no 32-key tiles: 16 keys where they fill the SMs
  no8            no 8-key tiles: 16 keys where the rule would take 8
  clocks         the committed kernel with clock64() counters: thread 0's
                 cycles per query tile in the partial S^T product, the
                 partial dP^T product, writing the partials and the first
                 cluster barrier, reading the peer's and forming P and dS up
                 to the second barrier, storing P^T and dS^T, and the dV and
                 dK accumulations
  parent_tuned   the parent's kernel with the accumulation unrolled 8 deep
                 and 3 columns a thread (the unclustered kernel, knobs tuned)
  parent_clocks  the parent's kernel with counters: cycles per query tile in
                 the S^T product, the dP^T product, the P/dS step and the
                 accumulation

``--clocks`` builds every variant chosen with the counters of ``clocks``
(or ``parent_clocks``) as ``<name>+clocks`` and times those instead.

One JSON line per variant, shape and dtype: the dK/dV kernel's ms (CUDA
events after warm-up), the largest |difference| from its plain version as
a share of each gradient's max, the launch plan where the checkout has
``dkdv_plan``, and the card's name and power limit; a `ptxas` line per
dK/dV instantiation gives registers and spills. Shapes as on the training
path (chip_smoke.py's inputs): 256^2 (B = 8 and 1), D = 1536, float32 and
bfloat16, and 128^2 (B = 1), float32, where the rule takes 8-key tiles.
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
CLOCKS = [
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
CLOCK_PHASES = ("S", "dP", "partials_sync", "peer_P_dS_sync", "store",
                "acc_dV", "acc_dK")
# the parent's kernel: one full-D block of 16 keys
PARENT_CLOCKS = [
    CLOCK_DECL, CLOCK_READ,
    ("""  for (int i = tid; i < 2 * R * D; i += kThreads) dk_acc[i] = 0.f;
""", """  for (int i = tid; i < 2 * R * D; i += kThreads) dk_acc[i] = 0.f;
  unsigned long long ph[5] = {0, 0, 0, 0, 0};
"""),
    ("""    float s[RPT][kCPT], dp[RPT][kCPT];
    tile_dot<T, T, R, 2>(Kb, j0, P, Qb, i0, N, ks_b, D, 0, D, as, bs, s);
    tile_dot<T, float, R, 0>(Vb, j0, P, dOb, i0, N, nullptr, D, 0, D, as, bs,
                             dp);
""", """    float s[RPT][kCPT], dp[RPT][kCPT];
    const long long c0 = clock64();
    tile_dot<T, T, R, 2>(Kb, j0, P, Qb, i0, N, ks_b, D, 0, D, as, bs, s);
    const long long c1 = clock64();
    tile_dot<T, float, R, 0>(Vb, j0, P, dOb, i0, N, nullptr, D, 0, D, as, bs,
                             dp);
    const long long c2 = clock64();
"""),
    ("""    __syncthreads();

    // dV += P^T dO and dK_eff += dS^T Q, one pass over this tile's queries.
""", """    __syncthreads();
    const long long c3 = clock64();

    // dV += P^T dO and dK_eff += dS^T Q, one pass over this tile's queries.
"""),
    ("""            dk_acc[rr * D + c0 + c * kThreads] = ak[c][rr];
          }
    }
  }
""", """            dk_acc[rr * D + c0 + c * kThreads] = ak[c][rr];
          }
    }
    ph[0] += c1 - c0; ph[1] += c2 - c1; ph[2] += c3 - c2;
    ph[3] += clock64() - c3; ph[4] += 1;
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < 5; ++i) atomicAdd(&g_clk[i], ph[i]);
"""),
]
PARENT_PHASES = ("S", "dP", "P_dS", "accumulate")
PARENT_TUNED = [
    ("""  constexpr int kNC = Tile<R>::kNC;
  constexpr int RPT = R / 4;

  extern __shared__ __align__(16) float smem[];
  float* dk_acc = smem;""", """  constexpr int kNC = 3;
  constexpr int RPT = R / 4;

  extern __shared__ __align__(16) float smem[];
  float* dk_acc = smem;"""),
    ("""#pragma unroll 2
      for (int ii = 0; ii < qn; ++ii) {""", """#pragma unroll 8
      for (int ii = 0; ii < qn; ++ii) {"""),
]
UNROLL = "  static constexpr int kUnroll = 8;"
NC = "  static constexpr int kNC = 3;"
# variant -> (base: this checkout or --parent, edits to csrc/..._bwd.cu)
VARIANTS = {
    "committed": ("self", []),
    "unroll2": ("self", [(UNROLL, UNROLL.replace("8", "2"))]),
    "unroll4": ("self", [(UNROLL, UNROLL.replace("8", "4"))]),
    "nc1": ("self", [(NC, NC.replace("3", "1"))]),
    "nc2": ("self", [(NC, NC.replace("3", "2"))]),
    "chunk32": ("self", [("  static constexpr int kDC = 64;",
                          "  static constexpr int kDC = 32;")]),
    "nopad": ("self", [("  static constexpr int kWLd = R + 4;",
                        "  static constexpr int kWLd = R;")]),
    "scaleq": ("self", [("tile_dot<T, T, R, 1, Tl::kDC>(Kb, j0, P, Qb",
                         "tile_dot<T, T, R, 2, Tl::kDC>(Kb, j0, P, Qb")]),
    "rows16": ("self", [(
        "      if (pairs(32) >= sm_count() && dkdv_smem_bytes<32>(Dh) <= "
        "kMaxSmem)\n        return launch_dkdv_r<T, 32>(a);\n", "")]),
    "no8": ("self", [("      return launch_dkdv_r<T, 8>(a);\n    }",
                      "      return launch_dkdv_r<T, 16>(a);\n    }")]),
    "clocks": ("self", CLOCKS),
    "parent_tuned": ("parent", PARENT_TUNED),
    "parent_clocks": ("parent", PARENT_CLOCKS),
}
SHAPES = ((8, 64, "float32"), (8, 64, "bfloat16"), (1, 64, "float32"),
          (1, 64, "bfloat16"), (1, 32, "float32"))


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
        row = {"variant": name, "image_hw": [4 * hw, 4 * hw],
               "shape_BNPD": [B, N, N, D], "dtype": dtype, "card": card_,
               "dkdv_ms": cuda_ms(lambda: ac.attention_core_dkdv(*bargs),
                                  10 if B > 1 else 20)}
        got = ac.attention_core_dkdv(*bargs)
        want = ac.attention_core_dkdv_reference(*bargs)
        row["max_abs_err_rel"] = max(
            ((g - w).abs().max() / w.abs().max().clamp_min(1e-6)).item()
            for g, w in zip(got, want))
        if hasattr(ac, "dkdv_plan"):
            row["plan"] = ac.dkdv_plan(B, N, N, D, Q.dtype)
        if "clocks" in name:
            phases, count = ((PARENT_PHASES, 4) if name.startswith("parent")
                             else (CLOCK_PHASES, 7))
            read = _build.load()["contextual_attention_bwd"
                                 ].sketchedit_clock_read
            read.argtypes = [ctypes.c_void_p]
            clk = (ctypes.c_ulonglong * 16)()
            torch.cuda.synchronize()
            assert read(ctypes.addressof(clk)) == 0      # zeroes them
            ac.attention_core_dkdv(*bargs)
            torch.cuda.synchronize()
            assert read(ctypes.addressof(clk)) == 0
            row["cycles_per_tile"] = {k: clk[i] / clk[count]
                                      for i, k in enumerate(phases)}
        print(json.dumps(row), flush=True)
        del f, Q, V, out, dO, bargs, got, want


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--parent", help="another checkout, timed as it is and "
                                     "the base of the parent_* variants")
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
    drive(__file__, roots)


if __name__ == "__main__":
    main()
