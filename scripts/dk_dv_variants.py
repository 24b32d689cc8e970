#!/usr/bin/env python3
"""Time design choices of the split-TF32 dV and dK backward kernels against
each other, and against an older checkout, on one GPU, in one run, in turns.

    python3 scripts/dk_dv_variants.py [--variants committed rows16 ...]
        [--parent DIR] [--clocks]
    python3 scripts/dk_dv_variants.py --precision

The harness is scripts/dsplit_variants.py's, as in scripts/dq_variants.py:
each variant is a copy of this checkout's sketchedit_tpu_torch with a few
textual edits to csrc/contextual_attention_bwd.cu (an edit whose anchor is
missing fails the run) under results/dk_dv_variants/<name>/, where it
builds its own kernels; all build in parallel, then each is timed in its
own process, in the order given and then in reverse. ``--parent DIR`` adds
another checkout as it is (an unpacked parent commit, whose dV and dK
kernels run on the CUDA cores) as the variant ``parent``. ``--clocks`` adds
``clocks``. Variants:

  committed  the kernels as committed: 16 key rows a block, 8 where 16-row
             blocks would leave SMs idle; 64-query tiles; S^T and dP^T as
             two loops, each staging one streamed tensor, in a 12.8 KB area a
             warp (three float32 steps in flight); the owned K tile in the
             input type (staging option (c)); where V is K, dP^T takes its
             A rows from the K tile
  rows16     16-row blocks everywhere
  rows8      8-row blocks everywhere (the lower half of every A tile zero)
  separate   dK stages V's owned rows with every dP^T step even where V is
             K (the build that separate K and V take): separate fragments
  area16k    a 16,000-byte area a warp (staging option (a)): three float32
             steps of dP^T where V is apart, more in bfloat16; the float32
             block then takes 232,192 bytes, so D is limited to 1536
  q32        32-query tiles (staging option (b)): twice the barriers and
             weight rows per query, half the partial registers
  tile_f32   the owned K tile held in float32 in both dtypes (option (c)
             undone: 99 KB in bfloat16 too)
  ks_global  kscale read from global memory by each S^T step as its A
             fragments are formed, not staged with the step
  clocks     the committed kernels with clock64() counters read back after
             one call each: thread 0's cycles per query tile in S^T (with
             its pipeline), dP^T and the partial stores, the barrier after
             them, the weight rows, the barrier after them, and the
             accumulation

One JSON line per variant, shape and dtype: dV's and dK's ms (CUDA events
after warm-up, the main path's call: Q = K = V one tensor, kscale, float32
dO), their largest |difference| from the plain versions as a share of the
largest value, the launch plans where the checkout has ``dk_dv_plan``, and
the card's name and power limit. ``committed`` and ``parent`` also time the
other five kernels at every shape: the default, shared and D-split forwards
(float32 output, as on the main path), dQ and the fused dK/dV. A `ptxas`
line per dV and dK instantiation gives registers and spills. Shapes as on
the training path (chip_smoke.py's inputs): 256^2, B = 1 and 8, D = 1536,
float32 and bfloat16.

``--precision`` times nothing: at the main path's one-tensor call (256^2,
B = 1 and 8, and a ragged 29^2, B = 3) it prints, per dtype, the largest
|difference| of the dV and dK kernels, the fused dK/dV kernel and the plain
versions (on the card and on the CPU) from a float64 evaluation of the same
function on the same inputs (the forward kernel's lse and delta), as a
share of its largest value, and the largest logit. Needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from dsplit_variants import ROOT, card, drive, make, report_ptxas  # noqa: E402

OUT = os.path.join(ROOT, "results", "dk_dv_variants")
BWD = os.path.join("sketchedit_tpu_torch", "csrc",
                   "contextual_attention_bwd.cu")

ROWS = "(long long)a.B * ((a.P + kRows - 1) / kRows) < sm_count() ? 8 : kRows"
CLOCK_PHASES = ("S", "dP", "sync", "weights", "weights_sync", "WX")
CLOCKS = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_clk[16];\n"),
    ("""    const int qn = min(kTq, N - i0);             // real queries of the tile
""", """    const int qn = min(kTq, N - i0);             // real queries of the tile
    const long long c0 = clock64();
"""),
    ("""    float dp[kTq / 8][4];
""", """    const long long c1 = clock64();
    float dp[kTq / 8][4];
"""),
    ("""    __syncthreads();  // every partial S^T (and dP^T) is written
""", """    const long long c2 = clock64();
    __syncthreads();  // every partial S^T (and dP^T) is written
    const long long c3 = clock64();
"""),
    ("""    __syncthreads();  // the weights are written; the partials are read
""", """    const long long c4 = clock64();
    __syncthreads();  // the weights are written; the partials are read
    const long long c5 = clock64();
"""),
    ("""    cp_wait<0>();
  }

  // each thread writes the columns it accumulated, as accumulated (dK_eff
""", """    cp_wait<0>();
    ph[0] += c1 - c0; ph[1] += c2 - c1; ph[2] += c3 - c2; ph[3] += c4 - c3;
    ph[4] += c5 - c4; ph[5] += clock64() - c5; ph[6] += 1;
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < 7; ++i) atomicAdd(&g_clk[i], ph[i]);

  // each thread writes the columns it accumulated, as accumulated (dK_eff
"""),
    ("""  for (int i0 = 0; i0 < N; i0 += kTq) {
""", """  unsigned long long ph[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int i0 = 0; i0 < N; i0 += kTq) {
"""),
    ("const char* sketchedit_cuda_error_string(int code) {",
     """int sketchedit_clock_read(unsigned long long* out) {
  const unsigned long long zero[16] = {0};
  int err = (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));
  return err ? err : (int)cudaMemcpyToSymbol(g_clk, zero, sizeof(zero));
}

const char* sketchedit_cuda_error_string(int code) {"""),
]
VARIANTS = {
    "committed": [],
    "rows16": [(ROWS, "kRows")],
    "rows8": [(ROWS, "8")],
    "separate": [("    if (a.k != a.v)\n", "    if (true)\n")],
    "area16k": [("constexpr int kDkArea = 12800;",
                 "constexpr int kDkArea = 16000;")],
    "q32": [("constexpr int kTq = kT;", "constexpr int kTq = 32;")],
    "tile_f32": [("template <typename T> using DkOwned = T;",
                  "template <typename T> using DkOwned = float;")],
    "ks_global": [
        ("""      const float4 ks =
          lds4(reinterpret_cast<const float*>(slot + kStepB) + 4 * t);""",
         "      const float4 ks = ldg4<kVec>(ks_b, d, D);"),
        ("(kScaleA ? 16 * (int)sizeof(float) : 0)", "0"),
        ("        if (lane < 4)\n", "        if (false)\n")],
    "clocks": CLOCKS,
}
SHAPES = ((1, "float32"), (8, "float32"), (1, "bfloat16"), (8, "bfloat16"))


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
    import torch

    from chip_smoke import cuda_ms
    from sketchedit_tpu_torch.ops import _build
    from sketchedit_tpu_torch.ops import attention_cuda as ac

    torch.backends.cuda.matmul.allow_tf32 = False
    card_ = card()
    f32 = torch.float32
    others = name in ("committed", "parent")
    for B, dtype in SHAPES:
        bargs = main_path_args(ac, torch, B, 64, getattr(torch, dtype))
        Q, K, V, keep, lse, _, dO, _, ksc = bargs
        B, N, D = Q.shape
        dv = lambda: ac.attention_core_dv(Q, K, keep, lse, dO, 10.0, ksc)
        dk = lambda: ac.attention_core_dk(*bargs)
        row = {"variant": name, "image_hw": [256, 256],
               "shape_BNPD": [B, N, N, D], "dtype": dtype, "card": card_,
               "dv_ms": cuda_ms(dv, 10, warmup=1),
               "dk_ms": cuda_ms(dk, 10, warmup=1)}
        for k, fn, want in (
                ("dv", dv, ac.attention_core_dv_reference(
                    Q, K, keep, lse, dO, 10.0, ksc)),
                ("dk", dk, ac.attention_core_dk_reference(*bargs))):
            row[f"{k}_max_abs_err_rel"] = ((fn() - want).abs().max()
                                           / want.abs().max()).item()
        if hasattr(ac, "dk_dv_plan"):
            row["plan"] = {k: ac.dk_dv_plan(B, N, N, D, Q.dtype, dk=k == "dk")
                           for k in ("dv", "dk")}
        if others:
            row["fwd_ms"] = cuda_ms(lambda: ac.attention_core(
                Q, V, V, keep, out_dtype=f32, kscale=ksc), 10, warmup=1)
            row["shared_ms"] = cuda_ms(lambda: ac.attention_core_shared(
                V, ksc, keep, out_dtype=f32), 10, warmup=1)
            row["dsplit_ms"] = cuda_ms(lambda: ac.attention_core_dsplit(
                Q, V, V, keep, out_dtype=f32, kscale=ksc), 10, warmup=1)
            row["dq_ms"] = cuda_ms(lambda: ac.attention_core_dq(*bargs), 10,
                                   warmup=1)
            row["dkdv_ms"] = cuda_ms(lambda: ac.attention_core_dkdv(*bargs),
                                     10, warmup=1)
        if "clocks" in name:
            read = _build.load()["contextual_attention_bwd"
                                 ].sketchedit_clock_read
            read.argtypes = [ctypes.c_void_p]
            clk = (ctypes.c_ulonglong * 16)()
            for k, fn in (("dv", dv), ("dk", dk)):
                torch.cuda.synchronize()
                assert read(ctypes.addressof(clk)) == 0      # zeroes them
                fn()
                torch.cuda.synchronize()
                assert read(ctypes.addressof(clk)) == 0
                tiles = clk[len(CLOCK_PHASES)]
                row[f"{k}_cycles_per_tile"] = {
                    p: clk[i] / tiles for i, p in enumerate(CLOCK_PHASES)}
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
                "dV": {"kernel": ac.attention_core_dv(
                           Q, K, keep, lse, dO, 10.0, ks),
                       "fused": fused[1],
                       "plain_gpu": ac.attention_core_dv_reference(
                           Q, K, keep, lse, dO, 10.0, ks),
                       "plain_cpu": ac.attention_core_dv_reference(
                           Qc, Kc, keep_c, lse_c, dO_c, 10.0, ks_c)},
                "dK_eff": {"kernel": ac.attention_core_dk(*args),
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
    ap.add_argument("--variants", nargs="+",
                    default=["committed", "rows16", "rows8", "separate",
                             "area16k", "q32", "tile_f32", "ks_global"],
                    choices=list(VARIANTS))
    ap.add_argument("--parent", help="another checkout, timed as it is")
    ap.add_argument("--clocks", action="store_true",
                    help="add the clocks variant")
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
        return report_ptxas(*args.build, "contextual_attention_bwd",
                            "ca_dk_or_dv_kernel")
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
