#!/usr/bin/env python3
"""Catch the unsteady first call of the port's CPU plain backward
(``attention_core_bwd_reference``) and log every OpenMP worker thread's
MXCSR around it, on the CPU.

    python3 scripts/mxcsr_probe_torch.py [--procs 60] [--parallel 4]

In some processes the first call of the plain backward on the inputs of
``tests/test_torch_attention_grad.py::test_bwd_reference_matches_pallas_kernels[gated]``
(2 x 130 x 150 x 70, seed 0) gives a dQ whose rows differ, in one
contiguous block, from every later call's. MXCSR, the SSE control and
status register, is per thread: a worker thread whose rounding mode or
flush-to-zero / denormals-are-zero bits differ would compute its share of
a product differently, which would show as such a block. Each of
``--procs`` fresh processes (``--parallel`` at a time) builds the inputs
with numpy (the forward's output and logsumexp from the port's plain
forward, where the test takes the JAX forward's), reads the MXCSR of
every thread of torch's OpenMP pool (a helper compiled with gcc -fopenmp
into build/mxcsr_probe/, which binds to the libgomp torch has loaded, so
its parallel region runs on the same pool that ATen and MKL use), calls
the backward twice, reads the MXCSRs again, and reports whether the two
calls differ and where. One JSON line
per process, then a summary: how many processes were bad, and whether the
control bits (rounding, FTZ, DAZ, exception masks: MXCSR & 0xffc0) of any
thread differed from the main thread's, in bad and in good processes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIB = os.path.join(ROOT, "build", "mxcsr_probe", "libmxcsr.so")
SOURCE = r"""
#include <omp.h>
#include <sys/syscall.h>
#include <unistd.h>
#include <xmmintrin.h>

/* Each thread of an OpenMP parallel region writes its MXCSR and kernel
   thread id; returns the team's size. */
int mxcsr_all(unsigned *csr, int *tid, int cap) {
  int n = 0;
#pragma omp parallel
  {
    int i = omp_get_thread_num();
    if (i < cap) {
      csr[i] = _mm_getcsr();
      tid[i] = (int)syscall(SYS_gettid);
    }
#pragma omp single
    n = omp_get_num_threads();
  }
  return n;
}

unsigned mxcsr_here(void) { return _mm_getcsr(); }
"""
CONTROL = 0xFFC0   # DAZ, the exception masks, rounding, FTZ


def build() -> str:
    os.makedirs(os.path.dirname(LIB), exist_ok=True)
    src = LIB[:-3] + ".c"
    with open(src, "w") as fh:
        fh.write(SOURCE)
    subprocess.run(["gcc", "-O2", "-fopenmp", "-shared", "-fPIC", "-o", LIB,
                    src], check=True)
    return LIB


def probe_one():
    """One process: the inputs, the pool's MXCSRs, two backward calls."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from sketchedit_tpu_torch.ops.attention_cuda import (
        attention_core_bwd_reference, attention_core_reference)

    lib = ctypes.CDLL(LIB)          # after torch: binds to its libgomp
    cap = 256
    lib.mxcsr_all.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    lib.mxcsr_here.restype = ctypes.c_uint

    def pool():
        csr, tid = (ctypes.c_uint * cap)(), (ctypes.c_int * cap)()
        n = lib.mxcsr_all(ctypes.addressof(csr), ctypes.addressof(tid), cap)
        return {str(tid[i]): hex(csr[i]) for i in range(min(n, cap))}

    rs = np.random.RandomState(0)           # the test's _core_inputs(0, ...)
    B, N, P, D = 2, 130, 150, 70
    Q = (rs.randn(B, N, D) * D ** -0.5).astype(np.float32)
    K = rs.randn(B, P, D).astype(np.float32)
    V = rs.randn(B, P, D).astype(np.float32)
    keep = (rs.rand(B, P) < 0.7).astype(np.float32)
    keep[0, :7] = 0.0
    dO = rs.randn(B, N, D).astype(np.float32)
    Q, K, V, keep, dO = map(torch.from_numpy, (Q, K, V, keep, dO))
    out, lse = attention_core_reference(Q, K, V, keep, 10.0, return_lse=True,
                                        out_dtype=torch.float32)
    before = pool()
    first = attention_core_bwd_reference(Q, K, V, keep, out, lse, dO, 10.0)
    after_first = pool()
    second = attention_core_bwd_reference(Q, K, V, keep, out, lse, dO, 10.0)
    after_second = pool()
    moved = {}
    for name, a, b in zip(("dQ", "dK", "dV"), first, second):
        diff = (a != b).nonzero()
        if len(diff):
            moved[name] = {"elements": len(diff),
                           "max_abs": (a - b).abs().max().item(),
                           "images": sorted({int(i) for i in diff[:, 0]}),
                           "rows": [int(diff[:, 1].min()),
                                    int(diff[:, 1].max())]}
    main = lib.mxcsr_here()
    odd = sorted({v for d in (before, after_first, after_second)
                  for v in d.values() if int(v, 16) & CONTROL
                  != main & CONTROL})
    print(json.dumps({"pid": os.getpid(), "bad": bool(moved),
                      "moved": moved, "main_thread": hex(main),
                      "threads": torch.get_num_threads(),
                      "pool_before": before, "pool_after_first": after_first,
                      "pool_after_second": after_second,
                      "control_bits_unlike_main": odd}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=60)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return probe_one()
    build()
    rows, running, left = [], [], args.procs
    while left or running:
        while left and len(running) < args.parallel:
            running.append(subprocess.Popen(
                [sys.executable, __file__, "--one"], stdout=subprocess.PIPE,
                text=True))
            left -= 1
        proc = running.pop(0)
        out, _ = proc.communicate(timeout=600)
        for ln in out.splitlines():
            if ln.startswith("{"):
                print(ln, flush=True)
                rows.append(json.loads(ln))
    bad = [r for r in rows if r["bad"]]
    print(json.dumps({
        "summary": True, "processes": len(rows), "bad": len(bad),
        "bad_with_odd_control_bits": sum(bool(r["control_bits_unlike_main"])
                                         for r in bad),
        "good_with_odd_control_bits": sum(
            bool(r["control_bits_unlike_main"]) for r in rows
            if not r["bad"]),
        "main_thread_values": sorted({r["main_thread"] for r in rows}),
        "pool_values": sorted({v for r in rows for k in (
            "pool_before", "pool_after_first", "pool_after_second")
            for v in r[k].values()}),
        "bad_moves": [r["moved"] for r in bad]}), flush=True)


if __name__ == "__main__":
    main()
