#!/usr/bin/env python3
"""Time design choices of the D-split attention forward against each other on
one GPU, in one run, in turns.

    python3 scripts/dsplit_variants.py [--variants committed rows16 ...]
        [--parent DIR]
    python3 scripts/dsplit_variants.py --precision

Each variant is this checkout's sketchedit_tpu_torch with a few textual
edits to csrc/contextual_attention_fwd.cu (an edit whose anchor is missing
fails the run), copied to results/dsplit_variants/<name>/, where it builds
its own kernels. ``--parent`` adds another checkout as it is (an unpacked
parent commit, say) as the variant ``parent``. All variants build in
parallel; then each is timed in its own process, in the order given and
then in reverse. Variants:

  committed  the kernel as committed: a cluster of two blocks per query
             tile, each contracting half of D for a partial S and
             accumulating its half of the output, 96 columns a warp in
             registers; both products split TF32 on the tensor cores;
             32-row tiles (two m16 tiles a block, which share each K and V
             fragment) where their clusters give every SM a block, else
             16 rows; K steps in flight three (float32) or five
             (bfloat16) ahead, V steps one or three ahead
  rows16     16-row clusters at every shape (no 32-row tiles)
  clocks     the committed kernel with clock64() counters read back after
             one call of the D-split: thread 0's cycles per key tile in the
             partial S (its block barrier included), the warp sum into the
             exchange slot, the exchange (the cluster barrier), the softmax
             (the peer's sum, P and alpha, and the block barrier) and P V
             (scripts/fwd_variants.py times the default forward's phases)

One JSON line per variant, shape and dtype: the D-split's, the default
forward's and the library call's ms (CUDA events after warm-up;
``F.scaled_dot_product_attention`` on the same function, which the port
never calls), the D-split's ratios to the other two, the largest
|difference| between the two kernels' outputs, and the card's name and
power limit; a `ptxas` line per D-split instantiation gives registers and
spills. Shapes as on the main path (chip_smoke.py's inputs): 256^2 (B = 1
and 8), 512^2 and 1024^2, D = 1536, float32, and 512^2 in bfloat16. Needs
a GPU.

``--precision`` times nothing: at the main path's call (256^2, B = 1, and
512^2; float32 and bfloat16; seeds 0-3 of chip_smoke.py's features and
hole mask) it prints the D-split's, the default forward's and the float32
plain version's distance from a float64 evaluation of the same function on
the same inputs: the largest |difference| and the relative L2 distance,
and the ratio of the D-split's to the default forward's.

The build-and-time harness (`make`, `report_ptxas`, `card`, `drive`) also
serves scripts/dkdv_variants.py and the other variant scripts.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "results", "dsplit_variants")
FWD = os.path.join("sketchedit_tpu_torch", "csrc", "contextual_attention_fwd.cu")

ROWS32 = ("    if (2 * blocks(2 * kRows) >= sm_count() &&\n",
          "    if (false &&\n")
CLOCKS = [
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_clk[16];\n"),
    # the D-split: partial S, warp sum, exchange, softmax, P V
    ("""  for (int k0 = 0, par = 0; k0 < P; k0 += kT, par ^= 1) {
""", """  unsigned long long ph[6] = {0, 0, 0, 0, 0, 0};
  for (int k0 = 0, par = 0; k0 < P; k0 += kT, par ^= 1) {
    const long long c0 = clock64();
"""),
    ("""    __syncthreads();  // every warp's partial is written
""", """    __syncthreads();  // every warp's partial is written
    const long long c1 = clock64();
"""),
    ("""    cluster.sync();  // both blocks' sums are written; every partial is read
""", """    const long long c2 = clock64();
    cluster.sync();  // both blocks' sums are written; every partial is read
    const long long c3 = clock64();
"""),
    ("""    __syncthreads();  // P and alpha are written
""", """    __syncthreads();  // P and alpha are written
    const long long c4 = clock64();
"""),
    ("""      cp_wait<0>();
    }
  }

  // l per row""", """      cp_wait<0>();
    }
    ph[0] += c1 - c0; ph[1] += c2 - c1; ph[2] += c3 - c2; ph[3] += c4 - c3;
    ph[4] += clock64() - c4; ph[5] += 1;
  }
  if (threadIdx.x == 0)
    for (int i = 0; i < 6; ++i) atomicAdd(&g_clk[8 + i], ph[i]);

  // l per row"""),
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
    "rows16": [ROWS32],
    "clocks": CLOCKS,
}
SHAPES = ((1, 64, "float32"), (8, 64, "float32"), (1, 128, "float32"),
          (1, 128, "bfloat16"), (1, 256, "float32"))


def make(name: str, edits, source: str = FWD, base: str = ROOT,
         out: str = OUT) -> str:
    """Copy ``base``'s sketchedit_tpu_torch to ``out/name`` and apply the
    textual ``edits`` (old, new) to ``source``; an anchor found other than
    once fails the run. Returns the copy's root."""
    dst = os.path.join(out, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(base, "sketchedit_tpu_torch"),
                    os.path.join(dst, "sketchedit_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, source)
    with open(path) as fh:
        src = fh.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{name}: anchor not found once in {source}: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    with open(path, "w") as fh:
        fh.write(src)
    return dst


def report_ptxas(root: str, name: str, stem: str, kernel: str):
    """Build the kernels of the checkout at ``root``; print registers and
    spills of every instantiation of ``kernel`` in the library ``stem``."""
    sys.path.insert(0, root)
    from sketchedit_tpu_torch.ops import _build
    _build.load()
    entry, spill = None, ""
    for ln in _build.build_log.get(stem, "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
        elif "spill" in ln:
            spill = ln.strip()
        elif "Used" in ln and entry and kernel in entry:
            args = re.search(kernel + r"I(\w+?)EEv", entry)
            print(json.dumps({"ptxas": name, "template": args and args.group(1),
                              "registers": ln.split(":", 1)[1].strip(),
                              "spills": spill}), flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def drive(script: str, roots: dict):
    """Build every variant ``{name: root}`` in parallel (``script --build
    ROOT NAME``), then time each in its own process (``script --time ROOT
    NAME``), in the order given and then in reverse."""
    procs = [subprocess.Popen([sys.executable, script, "--build", root,
                               name]) for name, root in roots.items()]
    if any([p.wait() for p in procs]):
        raise SystemExit(f"{os.path.basename(script)}: a build failed")
    for name in list(roots) + list(roots)[::-1]:
        subprocess.run([sys.executable, script, "--time", roots[name], name],
                       check=True)


def time_variant(root: str, name: str):
    sys.path[:0] = [root, ROOT]
    import numpy as np
    import torch
    import torch.nn.functional as F

    from chip_smoke import cuda_ms, features, hole_mask
    from sketchedit_tpu_torch.ops import _build
    from sketchedit_tpu_torch.ops.attention_cuda import (
        attention_core, attention_core_dsplit, attention_inputs)

    torch.backends.cuda.matmul.allow_tf32 = False
    card_ = card()
    rs = np.random.RandomState(0)
    f32 = torch.float32
    for B, hw, dtype in SHAPES:
        f = features(rs, B, hw, hw).cuda().to(getattr(torch, dtype))
        Q, V, keep, ksc = attention_inputs(f, f, hole_mask(B, hw, hw).cuda())
        fwd = lambda: attention_core(Q, V, V, keep, out_dtype=f32, kscale=ksc)
        dsplit = lambda: attention_core_dsplit(Q, V, V, keep, out_dtype=f32,
                                               kscale=ksc)
        Ks = (V.float() * ksc[:, None, :] * (10.0 * keep)[..., None]).to(
            Q.dtype)
        library = lambda: F.scaled_dot_product_attention(Q, Ks, V, scale=1.0)
        reps = 2 if hw == 256 else 5
        row = {"variant": name, "image_hw": [4 * hw, 4 * hw],
               "shape_BNPD": [B, Q.shape[1], V.shape[1], Q.shape[2]],
               "dtype": dtype, "card": card_,
               "fwd_ms": cuda_ms(fwd, reps, warmup=1),
               "dsplit_ms": cuda_ms(dsplit, reps, warmup=1),
               "library_ms": cuda_ms(library, reps, warmup=1)}
        row["dsplit_x_fwd"] = row["dsplit_ms"] / row["fwd_ms"]
        row["dsplit_x_library"] = row["dsplit_ms"] / row["library_ms"]
        if name != "parent":
            from sketchedit_tpu_torch.ops.attention_cuda import dsplit_plan
            row["plan"] = dsplit_plan(B, Q.shape[1], V.shape[1], Q.shape[2],
                                      Q.dtype)
        row["max_abs_diff"] = (dsplit() - fwd()).abs().max().item()
        if name == "clocks":
            read = _build.load()["contextual_attention_fwd"].sketchedit_clock_read
            read.argtypes = [ctypes.c_void_p]
            clk = (ctypes.c_ulonglong * 16)()
            for fn, key, lo, names in (
                    (dsplit, "dsplit_cycles_per_tile", 8,
                     ("partial_S", "warp_sum", "exchange", "softmax",
                      "PV")),):
                torch.cuda.synchronize()
                assert read(ctypes.addressof(clk)) == 0      # zeroes them
                fn()
                torch.cuda.synchronize()
                assert read(ctypes.addressof(clk)) == 0
                tiles = clk[lo + len(names)]
                row[key] = {k: clk[lo + i] / tiles for i, k in enumerate(names)}
        print(json.dumps(row), flush=True)
        del f, Q, V, Ks


def precision():
    sys.path[:0] = [ROOT]
    import numpy as np
    import torch

    from chip_smoke import features, hole_mask
    from sketchedit_tpu_torch.ops.attention_cuda import (
        attention_core, attention_core_dsplit, attention_core_reference,
        attention_inputs)

    torch.backends.cuda.matmul.allow_tf32 = False
    card_ = card()
    f32 = torch.float32
    for hw in (64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            for seed in range(4):
                rs = np.random.RandomState(seed)
                f = features(rs, 1, hw, hw).cuda().to(dtype)
                Q, V, keep, ksc = attention_inputs(
                    f, f, hole_mask(1, hw, hw).cuda())
                Vd = V.double()
                logits = torch.bmm(Q.double(), (Vd * ksc.double()[:, None, :])
                                   .transpose(1, 2))
                logits = logits * keep.double()[:, None, :] * 10.0
                exact = torch.bmm(torch.softmax(logits, -1), Vd)
                del logits, Vd
                row = {"precision": [4 * hw, 4 * hw], "dtype":
                       str(dtype).split(".")[-1], "seed": seed, "card": card_}
                for k, fn in (("dsplit", attention_core_dsplit),
                              ("fwd", attention_core),
                              ("plain", attention_core_reference)):
                    err = fn(Q, V, V, keep, out_dtype=f32,
                             kscale=ksc).double() - exact
                    row[f"{k}_max_abs"] = err.abs().max().item()
                    row[f"{k}_rel_l2"] = (err.norm() / exact.norm()).item()
                    del err
                for m in ("max_abs", "rel_l2"):
                    row[f"dsplit_x_fwd_{m}"] = (row[f"dsplit_{m}"]
                                                / row[f"fwd_{m}"])
                print(json.dumps(row), flush=True)
                del f, Q, V, exact


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--parent", help="another checkout, timed as it is")
    ap.add_argument("--precision", action="store_true",
                    help="distances from float64 instead of times")
    ap.add_argument("--build", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--time", nargs=2, metavar=("ROOT", "NAME"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.build:
        return report_ptxas(*args.build, "contextual_attention_fwd",
                            "dsplit_kernel")
    if args.time:
        return time_variant(*args.time)
    if args.precision:
        return precision()
    roots = {name: make(name, VARIANTS[name]) for name in args.variants}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    drive(__file__, roots)


if __name__ == "__main__":
    main()
