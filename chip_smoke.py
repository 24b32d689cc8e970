#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sketchedit_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--out results.jsonl]

Phases, in order; any failure raises and the exit code is not 0:

1. device: torch and CUDA versions, the card's name and power limit;
2. build: nvcc builds every kernel in sketchedit_tpu_torch/csrc;
3. kernels vs plain: the contextual-attention forward (its wgmma
   sequence), then the dQ and dK/dV backward kernels and the joint
   backward (bit for bit against the two at one chunk), against their plain
   PyTorch versions at the main paths' shapes (inference 256^2 B = 1, 4
   and 8, training 256^2 B = 1 and 8), float32 and bfloat16, plus ragged
   and all-gated cases, the forward with a scratch cap that takes its
   query rows in chunks (a `fwd_chunks` line each) and at D = 8195, and
   the sharded path's query slices (481 of 961 patches, B = 1 and 8); the
   shared-tensor and D-split forwards (256^2 B = 1 and 8, 512^2 and 1024^2
   B = 1; a `dsplit_plan` line gives the D-split's tile rows, cluster shape
   and resident clusters at each) and the dV and dK kernels the same way,
   each also against the kernel that computes the same function (the
   default forward, the fused dK/dV); a `dkdv_plan` line gives the fused
   dK/dV's wgmma sequence at each training shape (chunks and their key
   rows, the blocks, block shapes, stages, shared memory and resident
   blocks per SM of each product, launches per call, scratch bytes), a
   `dq_plan` line the same for dQ's wgmma sequence (chunks of query rows),
   a `bwd_plan` line for the joint backward, a `bwd_vs_float64` line each
   of its, the joint's, dQ's and the dK and dV kernels' distance from a
   float64 evaluation at 256^2 (B = 1 and 8, float32: the fused and joint
   sequences' relative L2 within 1.5x of theirs; dQ's over the fused
   dK_eff's within 1.5x of that ratio with the mma.sync dQ kernel it
   replaced), `dk_dv_plan` lines the dV and dK kernels' rows per block,
   column slabs, resident blocks per SM and shared memory, and
   `fwd_ptxas`, `dq_ptxas`, `dk_dv_ptxas`, `dkdv_ptxas` and
   `dsplit_ptxas` lines the forward's wgmma products', dQ's (its ca_dq_*
   kernels), the dV and dK, fused dK/dV (its ca_dkdv_* kernels) and
   D-split instantiations' registers and spills;
4. inference path: the runner's EditPipeline on uint8 batches at 256^2
   (B = 1 and 4, float32 and bfloat16) and 252^2, one forward launch per
   netG forward, checked against the same pipeline with dense attention
   and, at 64^2, against the port on the CPU;
5. train step: one G+D step at 256^2, B = 8, per branch flag, through the
   kernels and through the dense attention (losses and every gradient
   compared, launches counted: the default backward is the joint one), the
   same step under SKETCHEDIT_SPLIT_DKDV=1 and under
   SKETCHEDIT_SHARED_ATTN=1 against the default kernels' step,
   the bfloat16 step's gradients held to the float32 ones, and the step on
   the GPU against the step on the CPU;
6. training path: the train loop, 3 steps at 256^2, B = 8, in float32 and
   bfloat16 on batches from the editimage loader (synthetic PNGs), with
   the launch counts of the forward and the joint backward, and a saved
   checkpoint reloaded; held-out validation in process (8 items at 256^2,
   float32: the kernel path's metrics against a dense netG's with the same
   weights, one forward launch per call, its time); then the train CLI for
   2 steps, and for 2 epochs with --val_image_dir and --nThreads 2 (the
   spawned loader pool; val rows in metrics.jsonl, best_net_*);
   multi-device paths, every device being this one card (two shards, two
   replicas or two ranks on cuda:0: the paths compute what the
   single-device path computes; their times measure overhead, not
   scaling): `sharded_attention`, netG with the attention's query patches
   in two shards (--attention_impl sharded --gpu_ids 0,0) at B = 1 in both
   dtypes against the unsharded kernel path and the dense path (two
   forward launches per netG forward), one train step at B = 8 by default
   and under SKETCHEDIT_SPLIT_DKDV=1 against the unsharded step, and a
   1024^2 edit sharded and unsharded with both times; `dp_edit`, the
   pipeline with two replicas (--data_parallel 2 --gpu_ids 0,0) on a batch
   of 5; `dp_train_step`, two gloo ranks' averaged step against the
   single-process step on the same B = 8 batch, and one rank under NCCL;
   `dp_train_cli`, the train CLI on two ranks stopped by a SIGTERM to its
   process group (exit 143, the checkpoint written once);
7. CLI: the batch inference CLI with test_celeb.sh's flags;
8. serving: the BatchingExecutor on the EditPipeline in process (32
   concurrent submits; serve defaults and float32; the default, shared and
   D-split forwards, the last also at 512^2), one forward launch per
   dispatched batch, every float32 row held to 1 LSB of a B = 1 call fed
   the batch's hard mask (and of the B = 1 pipeline as it is where the
   hard masks agree); the serve CLI as a subprocess (JSON, raw bulk, a
   malformed body, /stats) under SKETCHEDIT_SHARED_ATTN=1 and under
   SKETCHEDIT_DSPLIT_ATTN=1 at --edit_size 512 (its in-process references
   through the default and the D-split forwards within 1 LSB of each
   other, `serve_references_dsplit_vs_default`; this process's cached
   device memory is handed back before each child process on the card is
   held to it, since the child's cuDNN picks its algorithms by the
   workspace it can get); the demo in process (with
   and without --face_crop) and over HTTP;
8b. serving from exported programs and the rest of the configuration
   space: `artifact`, each dtype's pipeline exported with torch.export at
   256^2 (B = 1 and 4), loaded and run in a fresh process that imports
   server/artifact.py alone (no model module may be imported), its uint8
   outputs within 1 LSB of the live pipeline's, one forward launch per call,
   ms per call beside the live edit's; the float32 pipeline exported again
   under SKETCHEDIT_SHARED_ATTN=1 and SKETCHEDIT_DSPLIT_ATTN=1 (the switch
   baked in: that kernel's launch, within 1 LSB of the default);
   `serve_artifact`, the serve CLI on the float32 B = 1 and B = 4
   artifacts alone answering 8 JSON posts from 4 clients, each within 1
   LSB of its bucket's artifact, /stats; `splitcam_variants`, netG at the
   eight reference splitcam configurations on the card against the CPU,
   no attention launch (the released one: one forward launch);
   `convergence`, scripts/convergence_check_torch.py in bfloat16 on the
   kernel route for 900 steps (its other defaults), which must end
   CONVERGES, with the exact launch counts, and the L1 ratios logged at
   step 450 (the default run's length) reported;
8c. `packing`: the space-to-depth packed fronts and tails
   (ops/packed_tail.py) against the plain layers: edit_u8 and netM and
   netG with pack on and off at 256^2 (B = 1 and 4, both dtypes; netG's
   five-layer tails under SKETCHEDIT_PACK_MID=1) and at 252^2 (the nets'
   packed grids at 126^2), each route's net outputs held to a float64
   evaluation of the same weights, each packed group (front pair, three-
   and five-layer tail) against its plain layers on the same input, one
   forward launch per packed edit; one G+D train step at 256^2, B = 8,
   packed against plain from the train state's own initialisation (losses;
   every gradient within relative L2 1e-2; exact launch counts); a float32
   artifact exported packed, run in a fresh process, against the live
   packed edit; then the ABBA times (``edit_ab``, ``train_ab``; also
   scripts/packing_ab_torch.py), packed and plain in turns, of the edit per
   dtype at B = 1, 4, 8, 32 and 64 (launches per call, and at B = 8
   float32 the three costliest conv kernels of each route) and of the
   train step at B = 8 in bfloat16 and in float32 with and without TF32;
9. times: CUDA events after warm-up (inference and train step, each
   kernel, its plain version and one PyTorch call computing the same
   function, the three forwards at 256^2 (B = 1 and 8), 512^2 and 1024^2
   with a `fwd_plan` line each (the default and shared forwards' phases,
   chunks, blocks of each launch, the products' block shapes, stages,
   shared memory, resident blocks per SM, registers and spills, and the
   scratch bytes) and, at 256^2 B = 1 and 512^2, the default and D-split
   forwards' distance from a float64 evaluation of the same function
   (`fwd_vs_float64`: each's relative L2 within 1.5x of the other's), served
   throughput per --max_batch and client count, the editimage loader's
   steady img/s per --nThreads over 50-batch epochs of 512^2 photo-like
   PNGs, alone and feeding the bfloat16 train loop, beside the loop over
   held batches and the bfloat16 step); one JSON line per item, and the `kernels` line. A float32 operations bound counts split TF32
   (three tensor-core passes) where that is faster than the CUDA cores.

The weights are random, drawn from --seed: kaiming init scaled by 1.8
(netM) and 1.5 (netG), since kaiming alone lets the gated activations
shrink every output to within 1e-3 of its midpoint, which would make the
checks vacuous. The last line is the JSON result; nothing of it is printed
when CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import argparse
import ast
import base64
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
GAIN_M, GAIN_G = 1.8, 1.5
CELEB_FLAGS = ["--batchSize", "1", "--nThreads", "1", "--name", "celeb",
               "--joint_train_inp", "--dataset_mode", "testimage",
               "--image_postfix", ".png", "--mask_postfix", ".png",
               "--model", "editline2", "--netG", "deepfillc2",
               "--pool_type", "max", "--use_cam", "--which_epoch", "latest"]
# test_celeb.sh's model flags, for the servers
SERVE_FLAGS = ["--name", "celeb", "--joint_train_inp", "--model", "editline2",
               "--netG", "deepfillc2", "--pool_type", "max", "--use_cam",
               "--which_epoch", "latest"]
SERVER_UP_S = 300       # a server subprocess must answer /healthz by then
# Published dense peaks (NVIDIA data sheets): float32 outside the tensor
# cores, TF32 and bfloat16 on them, FLOP/s; memory, bytes/s.
PEAKS = {
    "PCIe": {"float32": 51.2e12, "tf32": 378e12, "bfloat16": 756e12,
             "bytes": 2.0e12},
    "NVL": {"float32": 60e12, "tf32": 417.5e12, "bfloat16": 835e12,
            "bytes": 3.9e12},
    "SXM": {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
            "bytes": 3.35e12},
}
# by the kernel's output dtype: float32 differs from the plain version by
# summation order only; a bfloat16 output adds its own rounding
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# backward kernels vs plain, as a share of each gradient's max |value|:
# float32 arithmetic and outputs on both sides for either input type, with
# S recomputed in another summation order
BWD_TOL = 2e-4
# dQ's relative L2 from float64 over the fused dK/dV's dK_eff's at 256^2,
# float32, by batch, with the mma.sync dQ kernel that dQ's wgmma sequence
# replaced: the lowest over seeds 0-3 (scripts/dq_variants.py --seeds 4,
# PERF.md PR 18); the sequence must stay within 1.5x of it
DQ_F64_BEFORE = {1: 1.323, 8: 1.333}
# train step, kernel path vs dense path and GPU vs CPU (float32, TF32 off):
# each gradient tensor's relative L2 error, ||got - want|| / ||want||. The
# two sides differ by summation order only, but the discriminator's leaky
# ReLUs make its gradient piecewise smooth: a unit whose pre-activation lies
# within rounding of 0 takes the other slope, which moves single elements
# of the first layers' gradients by percents of the tensor's max |value|
# (a 1e-6 relative change of the generator's weights does it on the CPU at
# 64^2, B = 2). The relative L2 error stays well inside 1e-2 for such
# flips, while a wrong kernel (dK not folded with kscale, say) misses by
# O(1). The max-abs error relative to the max |value| is reported beside.
GRAD_TOL = 1e-2
# data-parallel train step against the single-process steps on the same
# rows (float32, TF32 off): relative L2 per gradient tensor, the losses to
# rtol 1e-4. cuDNN takes other algorithms at B = 4 than at B = 8, and in
# one process the mean of the two B = 4 halves' gradients is 1.03e-2 (netM)
# from the B = 8 step's, against 1.7e-7 with cuDNN off
# (scripts/dp_grad_numerics_torch.py). So the bound holds the ranks to
# those halves run in one process; the B = 8 step's distance is reported.
DP_GRAD_TOL = 1e-3
# two query shards, two replicas, two ranks: all on this one card
SHARDS = (torch.device("cuda", 0),) * 2
# tests/test_attention.py's splitcam configurations (constructor overrides)
SPLITCAM_VARIANTS = {
    "released": {}, "nn_hard": {"nn_hard": True},
    "is_th_false": {"is_th": False}, "mk_true": {"mk": True}, "pd1": {"pd": 1},
    "norm_type2": {"norm_type": 2}, "fuse": {"pd": 1, "is_fuse": True},
    "everything": {"pd": 1, "is_fuse": True, "is_th": False, "mk": True,
                   "nn_hard": True, "norm_type": 2, "th": 0.3},
}
# netG on the card against netG on the CPU, float32 with TF32 off: the same
# dense arithmetic in another summation order through ~50 convs, on tanh
# outputs of order 1 (1 LSB of the uint8 image is 7.8e-3). nn_hard's argmax
# could flip on a near tie; the top two weights of these inputs lie
# percents apart.
SPLITCAM_TOL = 1e-3
# packed against plain fronts and tails (ops/packed_tail.py): the same math
# in another summation order through ~50 convs. At 256^2 with these
# weights the plain float32 route itself lies ~1e-3 from float64 on netM's
# image (an absolute 1e-4 between the routes does not hold for either
# order), so each net output of each route is held to a float64 evaluation
# of the same weights: the packed route's relative L2 distance at most
# PACK_F64_RATIO times the plain route's, or within PACK_F64_FLOOR, where
# both sit at float32 roundoff (netG's coarse output: 1.3e-6 plain, 2.7e-6
# packed at B = 4, 2.6e-6 and 1.4e-6 at B = 1). Float32 composites within
# 1 LSB.
PACK_F64_RATIO = 2.0
PACK_F64_FLOOR = 1e-5
# each packed group (a front pair, a three- or five-layer tail) against its
# plain layers on the same input, max |packed - plain| over max |plain|:
# float32, summation order only; bfloat16, a few bfloat16 ulps (2^-7 at
# 1.0) from the layers' own roundings, the packed upsample kernels' summed
# taps rounded once instead of per tap
PACK_GROUP_TOL = {"float32": 1e-5, "bfloat16": 4 * 2.0 ** -7}
PACK_AB_BATCHES = (1, 4, 8, 32, 64)

lines: list[str] = []
T0 = time.perf_counter()


def emit(obj):
    """Print and keep one JSON line; a phase line gets ``t_s``, the seconds
    since the script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
    line = json.dumps(obj)
    lines.append(line)
    print(line, flush=True)


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


def ops_ms(flops: float, dtype: str, peaks: dict) -> float:
    """The least milliseconds the card's arithmetic needs for ``flops`` on
    inputs of ``dtype``: bfloat16 at the tensor cores' bfloat16 rate;
    float32 at the CUDA cores' rate or as split TF32 (three tensor-core
    passes for a float32-accurate product), whichever is faster."""
    if dtype != "float32":
        return flops / peaks[dtype] * 1e3
    return min(flops / peaks["float32"], 3 * flops / peaks["tf32"]) * 1e3


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of fn, by CUDA events after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def features(rs, B, H, W, C=96):
    """Non-negative gated-like pm features (pmconv6 ends in relu*sigmoid)."""
    a = np.maximum(rs.randn(B, C, H, W), 0) / (1 + np.exp(-rs.randn(B, C, H, W)))
    return torch.from_numpy(a.astype(np.float32))


def hole_mask(B, H, W, frac=0.4):
    m = torch.zeros(B, 1, H, W)
    h, w = int(H * frac), int(W * frac)
    m[:, :, (H - h) // 2:(H + h) // 2, (W - w) // 2:(W + w) // 2] = 1.0
    return m


def scale_weights_(net_m, net_g):
    with torch.no_grad():
        for net, gain in ((net_m, GAIN_M), (net_g, GAIN_G)):
            for conv in net.children():
                conv.weight.mul_(gain)


# launch counters of ops/attention_cuda.py: the three forwards (fwd_lse:
# those of any of them that wrote the logsumexp), the four backwards and the
# joint backward (bwd)
COUNTERS = {"fwd": "LAUNCHES", "shared": "LAUNCHES_SHARED",
            "dsplit": "LAUNCHES_DSPLIT", "fwd_lse": "LAUNCHES_LSE",
            "dq": "LAUNCHES_DQ", "dkdv": "LAUNCHES_DKDV", "bwd": "LAUNCHES_BWD",
            "dv": "LAUNCHES_DV", "dk": "LAUNCHES_DK"}


def counts(ac):
    return {k: getattr(ac, v) for k, v in COUNTERS.items()}


def set_counts(ac, values):
    for k, v in values.items():
        setattr(ac, COUNTERS[k], v)


def zero_counts(ac):
    set_counts(ac, dict.fromkeys(COUNTERS, 0))


def expect(**launched):
    """A full counter reading: the named counts, 0 everywhere else."""
    return {k: launched.get(k, 0) for k in COUNTERS}


def release_cached_memory():
    """Hand this process's cached, unused device memory back to the card
    before a child process on the same card is held to this one's results:
    cuDNN picks its conv algorithms by the workspace it can get, so a child
    left a few GB (the attention forwards' scratch and every earlier
    phase's tensors stay cached here) takes other algorithms, whose
    roundings flip netM's mask pixels near 0.5 (which this random-weight
    model has many of). The caller's own results do not change."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def env(**variables):
    """Set environment variables for a block (the kernels' switches are
    read on every call)."""
    saved = {k: os.environ.get(k) for k in variables}
    os.environ.update(variables)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url, data=None, ctype=None, timeout=120):
    """(status, body) of one request; an HTTP error status is returned."""
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, None


class Recorded:
    """A pipeline that keeps every batch it is given and what it returned."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.calls = []

    def __call__(self, images, sketches):
        out = self.pipeline(images, sketches)
        self.calls.append((images, sketches, out))
        return out


def u8_diff(a, b):
    return np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(
        np.int16))


def train_batch(B, H, seed):
    """A float NHWC train batch: random image, sparse sketch and edge map,
    a random rectangle per image as the inpainting mask and another as the
    context mask."""
    r = np.random.RandomState(seed)
    img = r.uniform(-1, 1, (B, H, H, 3)).astype(np.float32)
    out = {"image": img, "gt": img,
           "mask": (r.rand(B, H, H, 1) > 0.95).astype(np.float32),
           "edgegt": (r.rand(B, H, H, 1) > 0.9).astype(np.float32)}
    for k in ("random_mask", "random_mask2"):
        m = np.zeros((B, H, H, 1), np.float32)
        for b in range(B):
            h, w = r.randint(H // 4, H // 2, 2)
            y, x = r.randint(0, H - h), r.randint(0, H - w)
            m[b, y:y + h, x:x + w] = 1.0
        out[k] = m
    return out


# --- packed against plain fronts and tails (ops/packed_tail.py) ----------

PACK_ROUTES = (("packed", "1"), ("plain", "0"))     # SKETCHEDIT_PACK


def packed_groups():
    """Every packed group of the nets: (net, kind, layer names), kind
    'front' (an encoder's first two layers), 'tail' (a decoder's last
    three) or 'tail5' (netG's decoders' last five, under
    SKETCHEDIT_PACK_MID)."""
    from sketchedit_tpu_torch.models import deepfill_c2 as dg
    from sketchedit_tpu_torch.models import md_generator as md

    def names(specs):
        return [s[0] for s in specs]

    out = [("M", "front", names(md._ENCODER[:2]))]
    out += [("M", "tail", names(d[-3:]))
            for d in (md._IMAGE_DECODER, md._MASK_DECODER)]
    out += [("G", "front", names(e[:2])) for e in (
        dg._SPEC_CONV, dg._SPEC_WCONV, dg._SPEC_XCONV, dg._SPEC_PMCONV)]
    out += [("G", kind, names(d[-n:])) for d in (dg._SPEC_CONV_DEC,
                                                 dg._SPEC_ALLCONV_DEC)
            for kind, n in (("tail", 3), ("tail5", 5))]
    return out


def packed_group_errors(nets, run_plain):
    """Each packed group of ``nets`` ({'M': netM, 'G': netG}) against its
    plain layers on the input that the group's first layer got in
    ``run_plain()``, a plain forward of the nets (captured by hooks): per
    group, max |packed - plain| / max |plain| (both in the nets' dtype).
    Call it without autograd."""
    from sketchedit_tpu_torch.ops import packed_tail as pt
    run = {"front": pt.packed_encoder_front, "tail": pt.packed_decoder_tail,
           "tail5": pt.packed_decoder_tail5}
    groups = packed_groups()
    seen, hooks = {}, []
    for label, _, layers in groups:
        key = (label, layers[0])
        hooks.append(getattr(nets[label], layers[0]).register_forward_pre_hook(
            lambda mod, args, key=key: seen.setdefault(key, args[0])))
    try:
        run_plain()
    finally:
        for h in hooks:
            h.remove()
    errors = {}
    for label, kind, layers in groups:
        mods = [getattr(nets[label], n) for n in layers]
        x = want = seen[(label, layers[0])]
        for mod in mods:
            want = mod(want)
        got = run[kind](*mods, x).float()
        want = want.float()
        errors[f"{label}.{layers[0]}.{kind}"] = (
            (got - want).abs().max() / want.abs().max()).item()
    return errors


def reps_for(batch: int) -> int:
    """Calls per timed turn: about 32 images' worth, at least 2."""
    return max(2, 32 // batch)


def profiled(fn, top: bool):
    """Kernel launches of one call of fn, and its three costliest conv
    kernels (name, ms) when ``top`` (scripts/profile_rows_torch.py files
    them)."""
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from profile_rows_torch import category, kernel_times
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, launches = kernel_times(prof.events())
    convs = [(name[:120], ms) for name, ms in kernels
             if category(name) == "conv"][:3]
    return launches, (convs if top else None)


def edit_ab(model, batch: int, seed: int, top: bool = False,
            rounds: int = 1):
    """Packed against plain edits (``edit_u8`` at 256^2 on device uint8
    tensors), the route forced with SKETCHEDIT_PACK, in turns: packed,
    plain, plain, packed, ``rounds`` times. {route: row}: ms per call in
    each turn (CUDA events over ``reps_for(batch)`` calls after warm-up),
    launches per call and, with ``top``, the three costliest conv
    kernels."""
    from sketchedit_tpu_torch.models import editline2 as e2
    dev = next(model.parameters()).device
    r = np.random.RandomState(seed)
    img = torch.from_numpy(r.randint(0, 256, (batch, 256, 256, 3)).astype(
        np.uint8)).to(dev)
    sk = torch.from_numpy(((r.rand(batch, 256, 256, 1) > 0.92) * 255).astype(
        np.uint8)).to(dev)
    flags = dict(PACK_ROUTES)
    reps = reps_for(batch)
    rows = {route: {"ms": []} for route in flags}
    with torch.inference_mode():
        turns = ("packed", "plain", "plain", "packed") * rounds
        for i, route in enumerate(turns):
            with env(SKETCHEDIT_PACK=flags[route]):
                rows[route]["ms"].append(cuda_ms(
                    lambda: e2.edit_u8(model, img, sk), reps,
                    warmup=2 if i < 2 else 1))
        for route, row in rows.items():
            with env(SKETCHEDIT_PACK=flags[route]):
                row["launches"], row["top_conv_kernels"] = profiled(
                    lambda: e2.edit_u8(model, img, sk), top)
    for row in rows.values():
        row["reps"] = reps
        if row["top_conv_kernels"] is None:
            del row["top_conv_kernels"]
    return rows


def train_ab(state, cfg, batch: dict, reps: int = 3):
    """{route: ms per step in both turns (packed, plain, plain, packed)}
    for ``train_step`` on one state (flags 1, 1) and one device batch, the
    route forced with SKETCHEDIT_PACK."""
    from sketchedit_tpu_torch.train import trainer as tr
    rows = {route: [] for route, _ in PACK_ROUTES}
    flags = dict(PACK_ROUTES)
    for route in ("packed", "plain", "plain", "packed"):
        with env(SKETCHEDIT_PACK=flags[route]):
            rows[route].append(cuda_ms(
                lambda: tr.train_step(state, batch, 1, 1, cfg), reps,
                warmup=1))
    return rows


def photo_like(rs, size):
    """A seeded stand-in for a photograph: smooth colour fields, a few
    hard-edged shapes and mild sensor noise, as uint8 HWC."""
    from PIL import Image
    low = (rs.rand(8, 8, 3) * 255).astype(np.uint8)
    img = np.asarray(Image.fromarray(low).resize((size, size),
                                                 Image.BICUBIC), np.float32)
    for _ in range(6):
        y0, x0 = rs.randint(0, size - 32, 2)
        h, w = rs.randint(32, size // 2, 2)
        img[y0:y0 + h, x0:x0 + w] = (img[y0:y0 + h, x0:x0 + w] * 0.5
                                     + rs.rand(3) * 127)
    img += rs.randn(size, size, 3) * 4
    return np.clip(img, 0, 255).astype(np.uint8)


def dp_rank(rank, world, init_method, batch_path, out_path, seed):
    """One rank of the two-rank step on this card over gloo: rank 0's
    train state (seeded as the single-process one), one train_step at lr 0
    on this rank's rows (so the D half reads the same generator as the
    single-process step, and the parameters keep their gradients, averaged
    over the ranks), saved with the metrics and the launch counts."""
    from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
    from sketchedit_tpu_torch.ops import attention_cuda
    from sketchedit_tpu_torch.parallel import distributed
    from sketchedit_tpu_torch.runner import set_precision
    from sketchedit_tpu_torch.train import trainer as tr
    torch.cuda.set_device(SHARDS[rank])
    set_precision("highest")
    distributed.init(rank, world, "gloo", init_method)
    try:
        cfg = tr.TrainConfig(netg=DeepFillConfig(attention_impl="kernel"),
                             precision="highest", lr=0.0)
        state = tr.init_train_state(cfg, seed=seed + rank, device="cuda")
        scale_weights_(state.nets["M"], state.nets["G"])
        distributed.broadcast_(distributed.train_state_tensors(state))
        with np.load(batch_path) as f:
            n = len(f["image"]) // world
            rows = {k: f[k][rank * n:(rank + 1) * n] for k in f.files}
        zero_counts(attention_cuda)
        _, metrics = tr.train_step(state, tr.batch_to_device(rows, "cuda"),
                                   1, 1, cfg,
                                   group=torch.distributed.group.WORLD)
        torch.cuda.synchronize()
        out = {f"grad.{label}.{n}": p.grad.cpu().numpy()
               for label, net in state.nets.items()
               for n, p in net.named_parameters()}
        out.update({f"metric.{k}": float(v) for k, v in metrics.items()})
        out.update({f"count.{k}": v for k, v in counts(attention_cuda).items()})
        np.savez(out_path, **out)
    finally:
        distributed.close()


def artifact_probe(spec_path, out_path):
    """In a fresh process that imports server/artifact.py alone: load each
    artifact of the spec (a JSON list of tag, path and an .npz of inputs),
    run it once on its inputs with the launch counts read around the call,
    and save the outputs (``out_path``) and a report (``out_path``.json)
    that names every model module this process imported."""
    from sketchedit_tpu_torch.ops import attention_cuda
    from sketchedit_tpu_torch.server.artifact import load_edit_artifact
    with open(spec_path) as f:
        spec = json.load(f)
    report, outs = {}, {}
    for item in spec:
        call = load_edit_artifact(item["path"])
        with np.load(item["inputs"]) as z:
            img, sk = (torch.from_numpy(z[k]).to(call.device)
                       for k in ("image", "sketch"))
        with torch.inference_mode():
            zero_counts(attention_cuda)
            composed, mask = call(img, sk)
            torch.cuda.synchronize()
            used = counts(attention_cuda)
        outs[item["tag"] + ".composite"] = composed.cpu().numpy()
        outs[item["tag"] + ".mask"] = mask.cpu().numpy()
        report[item["tag"]] = {"launches": used, "meta": call.meta}
    report["model_modules"] = sorted(
        n for n in sys.modules
        if n.startswith(("sketchedit_tpu_torch.models",
                         "sketchedit_tpu_torch.runner")))
    np.savez(out_path, **outs)
    with open(out_path + ".json", "w") as f:
        json.dump(report, f)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from sketchedit_tpu_torch.ops import _build, attention_cuda
    from sketchedit_tpu_torch.ops.attention_cuda import (
        attention_core, attention_core_bwd_joint,
        attention_core_bwd_joint_reference, attention_core_dk,
        attention_core_dk_reference, attention_core_dkdv,
        attention_core_dkdv_reference,
        attention_core_dq, attention_core_dq_reference,
        attention_core_dsplit, attention_core_dsplit_reference,
        attention_core_dv, attention_core_dv_reference,
        attention_core_reference, attention_core_shared,
        attention_core_shared_reference, attention_inputs, bwd_plan,
        dk_dv_plan, dkdv_plan, dq_plan, dsplit_plan, fwd_plan)
    from sketchedit_tpu_torch.options import parse_argv
    from sketchedit_tpu_torch.options.test_options import TestOptions
    from sketchedit_tpu_torch.runner import build_pipeline, set_precision

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"card: {smi}")
    card = {"card": smi}
    part, peaks = card_peaks(kind)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    for name, log in _build.build_log.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln or "smem" in ln:
                print(f"ptxas[{name}]: {ln.strip()}")
    emit({"phase": "build", "seconds": round(build_s, 3),
          "nvcc_seconds": _build.build_seconds, **card})
    # registers and spills of each dQ instantiation (ca_dq_*: its products,
    # ca_dq_wgmma_kernel<kWN, kMW, kSplitB, kStages, kGroup, kCompensate>,
    # and its prep and weights kernels), each dV and dK one
    # (ca_dk_or_dv_kernel<T, kDK, kSame, kVec>), each fused dK/dV one
    # (ca_dkdv_*, the same kinds as dQ's) and each D-split
    # one (ca_fwd_dsplit_kernel<T, TO, kMT, kVec>), where this run built the
    # library
    ptxas = {}
    for phase, stem, kernel in (
            ("fwd_ptxas", "fwd", "ca_fwd_wgmma_kernel"),
            ("dq_ptxas", "bwd", "ca_dq_"),
            ("dk_dv_ptxas", "bwd", "ca_dk_or_dv_kernel"),
            ("dkdv_ptxas", "bwd", "ca_dkdv_"),
            ("dsplit_ptxas", "fwd", "ca_fwd_dsplit_kernel")):
        entry, found = None, []
        for ln in _build.build_log.get(f"contextual_attention_{stem}",
                                       "").splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1]
            elif "spill" in ln and entry and kernel in entry:
                found.append({"entry": entry, "spills": ln.strip()})
            elif "Used" in ln and entry and kernel in entry and found:
                found[-1]["registers"] = ln.split(":", 1)[1].strip()
        ptxas[phase] = found
        emit({"phase": phase, "instantiations": found})

    # 3. kernel vs plain --------------------------------------------------
    rs = np.random.RandomState(args.seed)
    errs = {}

    def check_core(tag, Q, K, V, keep, out_dtype=torch.float32, kscale=None):
        """The kernel against the plain version fed the same (bf16-rounded)
        inputs in float32; the tolerance follows the output's dtype."""
        before = attention_cuda.LAUNCHES
        out = attention_core(Q, K, V, keep, out_dtype=out_dtype,
                             kscale=kscale)
        torch.cuda.synchronize()
        assert attention_cuda.LAUNCHES == before + 1, tag
        want = attention_core_reference(Q.float(), K.float(), V.float(), keep,
                                        kscale=kscale)
        assert out.dtype == out_dtype and out.shape == want.shape, tag
        assert torch.isfinite(out).all(), tag
        tol = TOL[out_dtype]
        err = (out.float() - want).abs().max().item()
        torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol,
                                   msg=lambda m: f"{tag}: {m}")
        errs[tag] = err
        emit({"phase": "kernel_vs_plain", "case": tag,
              "shape_BNPD": [Q.shape[0], Q.shape[1], K.shape[1], Q.shape[2]],
              "dtype": str(Q.dtype).split(".")[-1],
              "out_dtype": str(out_dtype).split(".")[-1], "max_abs_err": err,
              "tol": tol})

    main_inputs = {}
    for B, hw, dtypes in ((1, 64, (torch.float32, torch.bfloat16)),
                          (4, 64, (torch.float32, torch.bfloat16)),
                          (8, 64, (torch.float32, torch.bfloat16)),
                          (1, 128, (torch.bfloat16,))):
        f = features(rs, B, hw, hw).to(dev)
        m = hole_mask(B, hw, hw).to(dev)
        for dt in dtypes:
            fd = f.to(dt)
            Q, V, keep, ksc = attention_inputs(fd, fd, m)   # as on the path
            check_core(f"B{B}_{hw}sq_{str(dt).split('.')[-1]}", Q, V, V, keep,
                       kscale=ksc)
            if dt == torch.bfloat16 and B == 1 and hw == 64:
                K = (V.float() * ksc[:, None, :]).to(dt)   # a K tensor, bf16 out
                check_core("B1_64sq_bfloat16_K_out_bf16", Q, K, V, keep,
                           out_dtype=torch.bfloat16)
            main_inputs[(B, hw, dt)] = (Q, V, keep, ksc)
    # Q / sqrt(D) keeps the logits near 10 in spread, as in the model
    Qr, Kr, Vr = (torch.from_numpy((rs.randn(2, n, 70) * sc).astype(
        np.float32)).to(dev) for n, sc in ((130, 70 ** -0.5), (150, 1.0),
                                           (150, 1.0)))
    keep_r = torch.from_numpy((rs.rand(2, 150) > 0.3).astype(np.float32)
                              ).to(dev)
    check_core("unaligned_2x130x150x70", Qr, Kr, Vr, keep_r)
    check_core("unaligned_2x130x150x70_bfloat16", *(
        t.to(torch.bfloat16) for t in (Qr, Kr, Vr)), keep_r)
    # a scratch cap that takes the query rows of 256^2, B = 2 in 64-row
    # chunks (the last one ragged): the same function, chunk by chunk
    fc = features(rs, 2, 64, 64).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        Q, V, keep, ksc = attention_inputs(fc.to(dt), fc.to(dt),
                                           hole_mask(2, 64, 64).to(dev))
        cap, attention_cuda.SCRATCH_CAP = attention_cuda.SCRATCH_CAP, 6 << 20
        try:
            plan = fwd_plan(2, Q.shape[1], V.shape[1], Q.shape[2], dt)
            assert plan["chunks"] > 1, plan
            check_core(f"chunked_B2_64sq_{str(dt).split('.')[-1]}", Q, V, V,
                       keep, kscale=ksc)
        finally:
            attention_cuda.SCRATCH_CAP = cap
        emit({"phase": "fwd_chunks", "dtype": str(dt).split(".")[-1],
              "scratch_cap": 6 << 20, "chunks": plan["chunks"],
              "chunk_rows": plan["chunk_rows"],
              "scratch_bytes": plan["scratch_bytes"]})
    del fc
    # D past the D-split's widest (3584): no bound from shared memory
    Qw, Kw, Vw = (torch.from_numpy((rs.randn(1, n, 8195) * sc).astype(
        np.float32)).to(dev) for n, sc in ((40, 8195 ** -0.5), (90, 1.0),
                                           (90, 1.0)))
    keep_w = torch.from_numpy((rs.rand(1, 90) > 0.3).astype(np.float32)
                              ).to(dev)
    check_core("wide_1x40x90x8195", Qw, Kw, Vw, keep_w)
    del Qw, Kw, Vw
    fa = features(rs, 1, 64, 64).to(dev)
    Q, V, keep, ksc = attention_inputs(fa, fa, torch.ones(1, 1, 64, 64,
                                                          device=dev))
    assert keep.sum().item() == 0
    check_core("all_gated", Q, V, V, keep, kscale=ksc)

    # the shared-tensor and D-split forwards: against their plain versions
    # and against the default kernel, which computes the same function
    variant_errs = {}

    def check_variant(tag, variant, Q, K, V, keep, kscale):
        """``variant`` (shared: Q, K and V are one tensor; dsplit) with a
        float32 output and the lse, against its plain version on the same
        (bf16-rounded) inputs and against attention_core."""
        before = counts(attention_cuda)
        if variant == "shared":
            assert Q is V and K is V
            out, lse = attention_core_shared(V, kscale, keep, return_lse=True,
                                             out_dtype=torch.float32)
            want, want_lse = attention_core_shared_reference(
                V.float(), kscale, keep, return_lse=True)
        else:
            out, lse = attention_core_dsplit(
                Q, K, V, keep, return_lse=True, out_dtype=torch.float32,
                kscale=kscale)
            want, want_lse = attention_core_dsplit_reference(
                Q.float(), K.float(), V.float(), keep, return_lse=True,
                kscale=kscale)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in counts(attention_cuda).items()}
        assert used == expect(**{variant: 1, "fwd_lse": 1}), (tag, used)
        sib, sib_lse = attention_core(Q, K, V, keep, return_lse=True,
                                      out_dtype=torch.float32, kscale=kscale)
        assert out.dtype == torch.float32 and out.shape == want.shape, tag
        assert torch.isfinite(out).all() and torch.isfinite(lse).all(), tag
        tol = TOL[torch.float32]
        row = {"phase": "variant_vs_plain", "kernel": variant, "case": tag,
               "shape_BNPD": [Q.shape[0], Q.shape[1], K.shape[1], Q.shape[2]],
               "dtype": str(V.dtype).split(".")[-1], "tol": tol,
               "max_abs_err": (out - want).abs().max().item(),
               "lse_max_abs_err": (lse - want_lse).abs().max().item(),
               "max_abs_diff_vs_fwd_kernel": (out - sib).abs().max().item()}
        for got, ref in ((out, want), (lse, want_lse), (out, sib),
                         (lse, sib_lse)):
            torch.testing.assert_close(got, ref, rtol=tol, atol=tol,
                                       msg=lambda m: f"{variant} {tag}: {m}")
        variant_errs[(variant, tag)] = row["max_abs_err"]
        emit(row)

    variant_inputs = {}
    for B, hw in ((1, 64), (8, 64), (1, 128), (1, 256)):
        f = features(rs, B, hw, hw).to(dev)
        m = hole_mask(B, hw, hw).to(dev)
        # 1024^2: the plain version's S is 1.04 GB; float32 only
        for dt in ((torch.float32,) if hw == 256
                   else (torch.float32, torch.bfloat16)):
            fd = f.to(dt)
            Q, V, keep, ksc = attention_inputs(fd, fd, m)
            tag = f"B{B}_{hw}sq_{str(dt).split('.')[-1]}"
            # how the D-split kernel runs this shape: tile rows, cluster
            # shape, clusters resident at once, against the grid's clusters
            emit({"phase": "dsplit_plan", "image_hw": [4 * hw, 4 * hw],
                  "shape_BNPD": [B, Q.shape[1], V.shape[1], Q.shape[2]],
                  "dtype": str(dt).split(".")[-1], "cluster_dims": [1, 2, 1],
                  **dsplit_plan(B, Q.shape[1], V.shape[1], Q.shape[2], dt),
                  **card})
            for variant in ("shared", "dsplit"):
                check_variant(tag, variant, Q, V, V, keep, ksc)
            if hw < 256:
                variant_inputs[(B, hw, dt)] = (Q, V, keep, ksc)
        del f, fd, Q, V
    ksc_r = torch.from_numpy(((0.5 + rs.rand(2, 70)) * 70 ** -0.5).astype(
        np.float32)).to(dev)
    check_variant("unaligned_2x150x150x70", "shared", Vr, Vr, Vr, keep_r,
                  ksc_r)
    check_variant("unaligned_2x130x150x70", "dsplit", Qr, Kr, Vr, keep_r,
                  ksc_r * 70 ** 0.5)
    Q, V, keep, ksc = attention_inputs(fa, fa, torch.ones(1, 1, 64, 64,
                                                          device=dev))
    for variant in ("shared", "dsplit"):
        check_variant("all_gated", variant, Q, V, V, keep, ksc)
    with torch.enable_grad():
        try:
            attention_core_dsplit(Q.clone().requires_grad_(), V, V, keep)
            raise AssertionError("the D-split kernel took a gradient")
        except RuntimeError as e:
            assert "SKETCHEDIT_DSPLIT_ATTN" in str(e), e

    bwd_errs = {}
    bwd_inputs = {}

    def check_bwd(tag, Q, K, V, keep, kscale):
        """dQ and (dK_eff, dV) from the two kernels and from the joint
        backward against their plain versions on the same inputs, the
        forward's lse and a random dO; the joint's three outputs equal the
        two kernels' bit for bit (one chunk: the same S, dP and dS, each
        product in the same order)."""
        out, lse = attention_core(Q, K, V, keep, return_lse=True,
                                  out_dtype=torch.float32, kscale=kscale)
        dO = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            args.seed)).to(dev)
        bargs = (Q, K, V, keep, lse, (dO * out).sum(-1), dO, 10.0, kscale)
        before = counts(attention_cuda)
        got = (attention_core_dq(*bargs), *attention_core_dkdv(*bargs))
        dV1 = attention_core_dv(Q, K, keep, lse, dO, 10.0, kscale)
        dK1 = attention_core_dk(*bargs)
        joint = attention_core_bwd_joint(*bargs)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in counts(attention_cuda).items()}
        assert used == expect(dq=1, dkdv=1, dv=1, dk=1, bwd=1), (tag, used)
        assert bwd_plan(Q.shape[0], Q.shape[1], K.shape[1],
                        Q.shape[2], Q.dtype)["chunks"] == 1, tag
        want = (attention_core_dq_reference(*bargs),
                *attention_core_dkdv_reference(*bargs))
        row = {"phase": "bwd_kernels_vs_plain", "case": tag,
               "shape_BNPD": [Q.shape[0], Q.shape[1], K.shape[1], Q.shape[2]],
               "dtype": str(Q.dtype).split(".")[-1], "tol_rel": BWD_TOL}
        for name, g, w in zip(("dQ", "dK_eff", "dV"), got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape, tag
            assert torch.isfinite(g).all(), f"{tag} {name}"
            scale = w.abs().max().item()
            err = (g - w).abs().max().item()
            row[f"{name}_max_abs_err"] = err
            row[f"{name}_max_abs"] = scale
            assert err <= BWD_TOL * max(scale, 1e-6), f"{tag} {name}: {err}"
        # the joint backward: against its plain version (P and dS formed
        # once) and bit for bit against the dQ and fused dK/dV kernels
        for name, g, w, two in zip(
                ("dQ", "dK_eff", "dV"), joint,
                attention_core_bwd_joint_reference(*bargs), got):
            assert g.dtype == torch.float32 and g.shape == w.shape, tag
            assert torch.isfinite(g).all(), f"{tag} joint {name}"
            row[f"joint_{name}_max_abs_err"] = (g - w).abs().max().item()
            row[f"joint_{name}_max_abs_diff_vs_two"] = (
                g - two).abs().max().item()
            assert row[f"joint_{name}_max_abs_err"] <= BWD_TOL * max(
                w.abs().max().item(), 1e-6), (tag, "joint", name)
        row["joint_bits_equal_two"] = all(
            torch.equal(g, two) for g, two in zip(joint, got))
        assert row["joint_bits_equal_two"], row
        # the single-output kernels: against their own plain versions and
        # against the fused kernel's outputs
        for name, g, w, sib in (
                ("dV_alone", dV1, attention_core_dv_reference(
                    Q, K, keep, lse, dO, 10.0, kscale), got[2]),
                ("dK_alone", dK1, attention_core_dk_reference(*bargs),
                 got[1])):
            assert g.dtype == torch.float32 and g.shape == w.shape, tag
            assert torch.isfinite(g).all(), f"{tag} {name}"
            scale = max(w.abs().max().item(), 1e-6)
            row[f"{name}_max_abs_err"] = (g - w).abs().max().item()
            row[f"{name}_max_abs_diff_vs_fused"] = (g - sib).abs().max().item()
            assert row[f"{name}_max_abs_err"] <= BWD_TOL * scale, (tag, name)
            assert row[f"{name}_max_abs_diff_vs_fused"] <= BWD_TOL * scale, (
                tag, name)
        bwd_errs[tag] = {"dq": row["dQ_max_abs_err"],
                         "dkdv": max(row["dK_eff_max_abs_err"],
                                     row["dV_max_abs_err"]),
                         "bwd": max(row[f"joint_{n}_max_abs_err"]
                                    for n in ("dQ", "dK_eff", "dV")),
                         "dv": row["dV_alone_max_abs_err"],
                         "dk": row["dK_alone_max_abs_err"]}
        emit(row)
        return bargs

    for B in (1, 8):      # the training path: 256^2 images, pm features 64^2
        f = features(rs, B, 64, 64).to(dev)
        m = hole_mask(B, 64, 64).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            fd = f.to(dt)
            Q, V, keep, ksc = attention_inputs(fd, fd, m)
            # how the fused dK/dV runs this shape: chunks of key rows, each
            # product's blocks, block shape, stages, shared memory and
            # resident blocks per SM, launches per call, scratch bytes
            emit({"phase": "dkdv_plan", "image_hw": [256, 256],
                  "shape_BNPD": [B, Q.shape[1], V.shape[1], Q.shape[2]],
                  "dtype": str(dt).split(".")[-1],
                  **dkdv_plan(B, Q.shape[1], V.shape[1], Q.shape[2], dt),
                  **card})
            # and the joint backward's: the same, with dQ's product
            emit({"phase": "bwd_plan", "image_hw": [256, 256],
                  "shape_BNPD": [B, Q.shape[1], V.shape[1], Q.shape[2]],
                  "dtype": str(dt).split(".")[-1],
                  **bwd_plan(B, Q.shape[1], V.shape[1], Q.shape[2], dt),
                  **card})
            # and dQ's: chunks of query rows, each product's blocks, block
            # shape, stages, shared memory and resident blocks per SM,
            # launches per call, scratch bytes
            emit({"phase": "dq_plan", "image_hw": [256, 256],
                  "shape_BNPD": [B, Q.shape[1], V.shape[1], Q.shape[2]],
                  "dtype": str(dt).split(".")[-1],
                  **dq_plan(B, Q.shape[1], V.shape[1], Q.shape[2], dt),
                  **card})
            # and the dV and dK kernels: key rows per block, column slabs,
            # blocks resident per SM, shared memory, the grid's blocks
            for dk in (False, True):
                emit({"phase": "dk_dv_plan", "kernel": "dk" if dk else "dv",
                      "image_hw": [256, 256],
                      "shape_BNPD": [B, Q.shape[1], V.shape[1], Q.shape[2]],
                      "dtype": str(dt).split(".")[-1],
                      **dk_dv_plan(B, Q.shape[1], V.shape[1], Q.shape[2], dt,
                                   dk=dk), **card})
            bwd_inputs[(B, dt)] = check_bwd(
                f"B{B}_64sq_{str(dt).split('.')[-1]}", Q, V, V, keep, ksc)
    # the query-sharded path's shapes: the first of two query slices (481
    # of 961 patches) against the whole bank, in float32 as that path forms
    # its inputs, at B = 1 (inference) and 8 (training)
    for B in (1, 8):
        f = features(rs, B, 64, 64).to(dev)
        _, V, keep, ksc = attention_inputs(f, f, hole_mask(B, 64, 64).to(dev))
        Qs = torch.tensor_split(V, 2, dim=1)[0].contiguous()
        check_core(f"B{B}_64sq_float32_qslice", Qs, V, V, keep, kscale=ksc)
        check_bwd(f"B{B}_64sq_float32_qslice", Qs, V, V, keep, ksc)
    check_bwd("unaligned_2x130x150x70", Qr, Kr, Vr, keep_r,
              torch.from_numpy((0.5 + rs.rand(2, 70)).astype(np.float32)
                               ).to(dev))
    Q, V, keep, ksc = attention_inputs(fa, fa, torch.ones(1, 1, 64, 64,
                                                          device=dev))
    check_bwd("all_gated", Q, V, V, keep, ksc)
    # the fused dK/dV, dQ and the dK and dV kernels against a float64
    # evaluation of the same function at the training path's call (256^2,
    # B = 1 and 8, float32): all run split TF32, and the fused sequence,
    # whose S and dP sum runs of 16 k8 steps where the single-output
    # kernels sum per-warp partials, must be as close (relative L2 within
    # 1.5x of theirs, each gradient); dQ's relative L2 over the fused
    # dK_eff's must stay within 1.5x of that ratio with the mma.sync dQ
    # kernel that dQ's wgmma sequence replaced (DQ_F64_BEFORE); the largest
    # |difference| is reported
    for B in (1, 8):
        bargs = bwd_inputs[(B, torch.float32)]
        Q, K, V, keep, lse, delta, dO, sc, ksc = bargs
        Qd = Q.double()
        g = keep.double()[:, None, :] * sc
        Pd = torch.exp(torch.bmm(Qd, (K.double() * ksc.double()[:, None, :])
                                 .transpose(1, 2)) * g
                       - lse.double()[..., None])
        dSd = Pd * (torch.bmm(dO.double(), V.double().transpose(1, 2))
                    - delta.double()[..., None]) * g
        exact = (torch.bmm(dSd.transpose(1, 2), Qd),
                 torch.bmm(Pd.transpose(1, 2), dO.double()))
        exact_dq = torch.bmm(dSd, K.double() * ksc.double()[:, None, :])
        del Pd, dSd, Qd
        dq_diff = attention_core_dq(*bargs).double() - exact_dq
        fused = attention_core_dkdv(*bargs)
        joint = attention_core_bwd_joint(*bargs)
        alone = (attention_core_dk(*bargs),
                 attention_core_dv(Q, K, keep, lse, dO, sc, ksc))
        row = {"phase": "bwd_vs_float64", "image_hw": [256, 256],
               "shape_BNPD": [B, Q.shape[1], K.shape[1], Q.shape[2]],
               "dtype": "float32", "ratio_max": 1.5}
        for name, f_, a_, w in zip(("dK_eff", "dV"), fused, alone, exact):
            for k, got in (("fused", f_), ("alone", a_)):
                diff = got.double() - w
                row[f"{name}_{k}_rel_l2_vs_float64"] = (
                    diff.norm() / w.norm()).item()
                row[f"{name}_{k}_max_abs_vs_float64"] = diff.abs().max().item()
            row[f"{name}_fused_x_alone_rel_l2"] = (
                row[f"{name}_fused_rel_l2_vs_float64"]
                / row[f"{name}_alone_rel_l2_vs_float64"])
        row["dQ_rel_l2_vs_float64"] = (dq_diff.norm()
                                       / exact_dq.norm()).item()
        row["dQ_max_abs_vs_float64"] = dq_diff.abs().max().item()
        row["dQ_x_dK_eff_rel_l2"] = (row["dQ_rel_l2_vs_float64"]
                                     / row["dK_eff_fused_rel_l2_vs_float64"])
        row["dQ_x_dK_eff_before"] = DQ_F64_BEFORE[B]
        # the joint backward's three, held to the same bars
        for name, g, w in zip(("dQ", "dK_eff", "dV"), joint,
                              (exact_dq, *exact)):
            diff = g.double() - w
            row[f"joint_{name}_rel_l2_vs_float64"] = (
                diff.norm() / w.norm()).item()
            row[f"joint_{name}_max_abs_vs_float64"] = diff.abs().max().item()
        for name in ("dK_eff", "dV"):
            row[f"joint_{name}_x_alone_rel_l2"] = (
                row[f"joint_{name}_rel_l2_vs_float64"]
                / row[f"{name}_alone_rel_l2_vs_float64"])
        row["joint_dQ_x_dK_eff_rel_l2"] = (
            row["joint_dQ_rel_l2_vs_float64"]
            / row["joint_dK_eff_rel_l2_vs_float64"])
        emit({**row, **card})
        for name in ("dK_eff", "dV"):
            assert row[f"{name}_fused_x_alone_rel_l2"] <= 1.5, row
            assert row[f"joint_{name}_x_alone_rel_l2"] <= 1.5, row
        assert row["dQ_x_dK_eff_rel_l2"] <= 1.5 * DQ_F64_BEFORE[B], row
        assert row["joint_dQ_x_dK_eff_rel_l2"] <= 1.5 * DQ_F64_BEFORE[B], row
        del exact, exact_dq, dq_diff, fused, alone, joint

    # 4. main path --------------------------------------------------------
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")   # removed at exit
    ckdir = os.path.join(tmp.name, "ck")

    def pipeline(dtype, impl, device="cuda", *extra):
        with contextlib.redirect_stdout(io.StringIO()):
            opt = parse_argv(TestOptions, [
            "--name", "celeb", "--checkpoints_dir", ckdir, "--use_cam",
            "--pool_type", "max", "--joint_train_inp", "--init_type",
            "kaiming", "--device", device, "--compute_dtype", dtype,
            "--attention_impl", impl, *extra])
        with contextlib.redirect_stdout(io.StringIO()):   # option dumps
            p = build_pipeline(opt, seed=args.seed)
        scale_weights_(p.model.netM, p.model.netG)
        return p

    def batch(B, H, W, seed):
        r = np.random.RandomState(seed)
        img = r.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
        sk = ((r.rand(B, H, W, 1) > 0.92) * 255).astype(np.uint8)
        return img, sk

    def netg_outputs(img, sk, pipes_):
        """netG's x_stage2 from each pipeline's model on the same inputs
        and the same hard mask (the first pipeline's netM), in float32."""
        from sketchedit_tpu_torch.models.editline2 import generate
        x = torch.from_numpy(img).to(dev).permute(0, 3, 1, 2) / 127.5 - 1.0
        s_ = (torch.from_numpy(sk).to(dev).permute(0, 3, 1, 2) > 0).float()
        with torch.inference_mode():
            hard = generate(pipes_[0].model, x, s_)["mask_inpaint"]
            outs = []
            for p in pipes_:
                dt_ = p.config.dtype
                xd, hd, sd = x.to(dt_), hard.to(dt_), s_.to(dt_)
                outs.append(p.model.netG(xd, xd, hd, hd, sd)[1].float())
        return outs

    cases = [("float32", 1, 256, 256), ("float32", 4, 256, 256),
             ("bfloat16", 1, 256, 256), ("bfloat16", 4, 256, 256),
             ("float32", 1, 252, 252)]
    pipes = {dt: pipeline(dt, "auto") for dt in ("float32", "bfloat16")}
    batches = [batch(B, H, W, args.seed + i)
               for i, (_, B, H, W) in enumerate(cases)]
    results = []
    launches = {"float32": 0, "bfloat16": 0}
    # the float32 kernels' launches on the multi-device paths (every one of
    # them forms its attention inputs in float32)
    multi_launches = dict.fromkeys(COUNTERS, 0)
    zero_counts(attention_cuda)
    for (dt, B, H, W), (img, sk) in zip(cases, batches):
        before = attention_cuda.LAUNCHES
        composed, mask = pipes[dt](img, sk)
        assert attention_cuda.LAUNCHES == before + 1, "one launch per netG"
        launches[dt] += attention_cuda.LAUNCHES - before
        results.append((composed, mask))
    assert all(launches.values())
    assert counts(attention_cuda) == expect(fwd=len(cases))

    # The kernel path against the dense path on the same batch. float32:
    # composed within 1 LSB. bfloat16: both compute the attention in
    # float32 from the same bf16 features, but in another summation order,
    # so a few of its outputs round to the neighbouring bf16 value, and the
    # ~40 bf16 convs after it amplify such 1-ulp differences to several
    # LSB. So both bf16 netGs are held to the float32 netG on the same
    # inputs and hard mask: the kernel path's mean error may exceed the
    # dense path's by at most 5%.
    dense = {dt: pipeline(dt, "dense") for dt in ("float32", "bfloat16")}
    for (dt, B, H, W), (img, sk), (composed, mask) in zip(cases, batches,
                                                          results):
        assert composed.shape == (B, H, W, 3) and mask.shape == (B, H, W, 1)
        assert composed.dtype == np.uint8 and mask.dtype == np.uint8
        d_composed, d_mask = dense[dt](img, sk)
        diff = np.abs(composed.astype(int) - d_composed.astype(int))
        changed = float((np.abs(composed.astype(int) - img) > 8).mean())
        row = {"phase": "main_path", "dtype": dt, "batch": B, "hw": [H, W],
               "max_u8_diff_vs_dense": int(diff.max()),
               "frac_u8_diff_vs_dense": float((diff > 0).mean()),
               "mask_equal": bool((mask == d_mask).all()),
               "mask_mean": float(mask.mean()) / 255,
               "frac_pixels_edited": changed}
        assert (mask == d_mask).all(), "soft masks differ"
        assert 0.01 < changed, "the edit changed nothing"
        if dt == "float32":
            emit(row)
            assert diff.max() <= 1, f"B{B} {H}x{W}: kernel vs dense {diff.max()}"
            continue
        fakes = netg_outputs(img, sk, [pipes[dt], dense[dt],
                                       dense["float32"]])
        k_err = (fakes[0] - fakes[2]).abs() * 127.5    # in uint8 steps
        d_err = (fakes[1] - fakes[2]).abs() * 127.5
        row.update({"netG_kernel_vs_f32_mean": k_err.mean().item(),
                    "netG_kernel_vs_f32_max": k_err.max().item(),
                    "netG_dense_vs_f32_mean": d_err.mean().item(),
                    "netG_dense_vs_f32_max": d_err.max().item()})
        emit(row)
        assert k_err.mean() <= 1.05 * d_err.mean(), "bf16 kernel path error"

    cpu = pipeline("float32", "auto", device="cpu")
    img, sk = batch(2, 64, 64, args.seed + 99)
    g_c, g_m = pipes["float32"](img, sk)
    c_c, c_m = cpu(img, sk)
    cpu_diff = int(np.abs(g_c.astype(int) - c_c.astype(int)).max())
    mask_diff = int(np.abs(g_m.astype(int) - c_m.astype(int)).max())
    emit({"phase": "gpu_vs_cpu", "hw": [64, 64], "batch": 2,
          "max_u8_diff": cpu_diff, "max_mask_u8_diff": mask_diff})
    assert cpu_diff <= 1 and mask_diff <= 1, "GPU and CPU runs disagree"

    # query-sharded attention (--attention_impl sharded --gpu_ids 0,0): netG
    # with its attention's query patches split in two, both shards on this
    # card, at B = 1 against the unsharded kernel path and the dense path on
    # the same batch. Two forward launches per netG forward, one per shard.
    # In float32 the composed image within 1 LSB of both; in bfloat16 the
    # sharded path forms its attention inputs in float32 (as the JAX one
    # does), and its netG is held to the float32 dense netG as the kernel
    # path is above.
    sharded = {dt: pipeline(dt, "sharded", "cuda", "--gpu_ids", "0,0")
               for dt in ("float32", "bfloat16")}
    for dt, p in sharded.items():
        assert p.config.netg.attention_devices == SHARDS and not p.replicas
        img, sk = batch(1, 256, 256, args.seed + 500)
        zero_counts(attention_cuda)
        composed, mask = p(img, sk)
        torch.cuda.synchronize()
        used = counts(attention_cuda)
        assert used == expect(fwd=2), used
        multi_launches["fwd"] += used["fwd"]
        k_c, k_m = pipes[dt](img, sk)
        d_c, d_m = dense[dt](img, sk)
        row = {"phase": "sharded_attention", "path": "edit", "dtype": dt,
               "batch": 1, "hw": [256, 256], "shards": [str(d) for d in SHARDS],
               "launches": used,
               "max_u8_diff_vs_kernel": int(u8_diff(composed, k_c).max()),
               "max_u8_diff_vs_dense": int(u8_diff(composed, d_c).max()),
               "mask_equal_kernel": bool((mask == k_m).all()),
               "mask_equal_dense": bool((mask == d_m).all())}
        if dt == "float32":
            emit(row)
            assert row["max_u8_diff_vs_kernel"] <= 1, row
            assert row["max_u8_diff_vs_dense"] <= 1, row
            continue
        fakes = netg_outputs(img, sk, [p, dense[dt], dense["float32"]])
        s_err = (fakes[0] - fakes[2]).abs() * 127.5
        d_err = (fakes[1] - fakes[2]).abs() * 127.5
        row.update({"netG_sharded_vs_f32_mean": s_err.mean().item(),
                    "netG_dense_vs_f32_mean": d_err.mean().item()})
        emit(row)
        assert s_err.mean() <= 1.05 * d_err.mean(), row
    # a 1024^2 float32 edit (16129 query patches, 8065 a shard), sharded
    # and unsharded; two shards on one card time the sharding's overhead
    img, sk = batch(1, 1024, 1024, args.seed + 501)
    big = sharded["float32"](img, sk)
    want_big = pipes["float32"](img, sk)
    big_ms = cuda_ms(lambda: sharded["float32"](img, sk), reps=3, warmup=1)
    one_ms = cuda_ms(lambda: pipes["float32"](img, sk), reps=3, warmup=1)
    emit({"phase": "sharded_attention", "path": "edit", "dtype": "float32",
          "batch": 1, "hw": [1024, 1024], "shards": 2,
          "max_u8_diff_vs_kernel": int(u8_diff(big[0], want_big[0]).max()),
          "frac_u8_diff_vs_kernel": float((u8_diff(big[0], want_big[0]) > 0
                                           ).mean()),
          "mask_equal_kernel": bool((big[1] == want_big[1]).all()),
          "sharded_ms": big_ms, "unsharded_ms": one_ms,
          "note": "two shards on one card: overhead, not scaling", **card})
    del sharded, big, want_big

    # 5. train step --------------------------------------------------------
    from sketchedit_tpu_torch.cli.train import train_loop
    from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
    from sketchedit_tpu_torch.params import checkpoint as ckpt
    from sketchedit_tpu_torch.train import trainer as tr

    def train_state(dtype, impl, device="cuda", precision="highest",
                    scaled=True):
        """A seeded train state, netM's and netG's weights scaled as the
        module docstring says unless not ``scaled`` (the state's own
        initialisation, as a training run starts)."""
        cfg = tr.TrainConfig(netg=DeepFillConfig(
            attention_impl=impl,
            attention_devices=SHARDS if impl == "sharded" else ()),
            compute_dtype=dtype, precision=precision)
        state = tr.init_train_state(cfg, seed=args.seed, device=device)
        if scaled:
            scale_weights_(state.nets["M"], state.nets["G"])
        return state, cfg

    def one_step(dtype, impl, batch, flags, device="cuda", scaled=True):
        """One train_step from a fresh state (its metrics and launch
        counts), and its gradients: the step's two halves on another fresh
        state, the D half before the G update, so that both attention paths
        regenerate the fakes from the same generator weights (after the
        update they differ where Adam's first step takes the sign of a
        noise-level gradient)."""
        state, cfg = train_state(dtype, impl, device, scaled=scaled)
        before = counts(attention_cuda)
        _, metrics = tr.train_step(state, tr.batch_to_device(batch, device),
                                   *flags, cfg)
        if device == "cuda":
            torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in counts(attention_cuda).items()}
        state, cfg = train_state(dtype, impl, device, scaled=scaled)
        tb = tr.decompress_batch(tr.batch_to_device(batch, device))
        _, _, g_pairs, _ = tr.g_step_grads(state, tb, flags[0], cfg)
        _, _, _, d_pairs, _ = tr.d_step_grads(state, tb, flags[1], cfg)
        names = [f"{label}.{n}" for label in ("M", "G", "D")
                 for n, _ in state.nets[label].named_parameters()]
        grads = {n: torch.zeros_like(p) if g is None else g.detach().float()
                 for n, (p, g) in zip(names, [*g_pairs, *d_pairs])}
        return {k: float(v) for k, v in metrics.items()}, grads, used

    def grad_errors(got, want):
        """Per net, the worst relative L2 error over its gradient tensors,
        each held to GRAD_TOL, and the worst max|got - want| / max|want|."""
        worst = {}
        for k, w in want.items():
            diff = got[k].to(w.device) - w
            norm = w.norm().item()
            if norm == 0:
                assert diff.abs().max().item() <= 1e-6, f"gradient {k}"
                continue
            l2 = diff.norm().item() / norm
            rel_max = diff.abs().max().item() / w.abs().max().item()
            assert l2 <= GRAD_TOL, f"gradient {k}: relative L2 {l2}"
            net = k.split(".")[0]
            l2_w, max_w = worst.get(net, (0.0, 0.0))
            worst[net] = (max(l2_w, l2), max(max_w, rel_max))
        return {"rel_l2": {n: v[0] for n, v in worst.items()},
                "rel_max": {n: v[1] for n, v in worst.items()}}

    def losses_agree(got, want):
        """G losses within 1e-4 (the G half runs before any update); the D
        losses read fakes of the updated generator: 1e-2."""
        for k in want:
            assert np.isfinite(got[k]), k
            rtol = 1e-2 if k.startswith("D_") else 1e-4
            assert abs(got[k] - want[k]) <= rtol * abs(want[k]) + 1e-6, (
                k, got[k], want[k])
        return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)
                   for k in want)

    batch8 = train_batch(8, 256, args.seed + 200)
    default_step = {}
    for flag in (0, 1, 2):
        m_k, g_k, n_k = one_step("float32", "kernel", batch8, (flag, flag))
        default_step[flag] = (m_k, g_k)
        m_d, g_d, n_d = one_step("float32", "dense", batch8, (flag, flag))
        # one forward with lse and one joint backward in the G step; one
        # forward without lse in the D step's regeneration of the fakes
        assert n_k == expect(fwd=2, fwd_lse=1, bwd=1), n_k
        assert not any(n_d.values()), n_d
        loss_diff = losses_agree(m_k, m_d)
        worst = grad_errors(g_k, g_d)
        emit({"phase": "train_step_kernel_vs_dense", "hw": [256, 256],
              "batch": 8, "dtype": "float32", "flag": flag, "losses": m_k,
              "max_loss_rel_diff": loss_diff, "grad_err": worst,
              "grad_tol": GRAD_TOL, "launches": n_k})

    # the same step through the kernels that the switches select, against
    # the default kernels' step: exact launch counts (the G step's forward
    # with lse and its backward; the D step's forward without lse)
    switch_launches = {}
    for switch, want in (
            ("SKETCHEDIT_SPLIT_DKDV",
             expect(fwd=2, fwd_lse=1, dq=1, dv=1, dk=1)),
            ("SKETCHEDIT_SHARED_ATTN",
             expect(shared=2, fwd_lse=1, bwd=1))):
        with env(**{switch: "1"}):
            m_s, g_s, n_s = one_step("float32", "kernel", batch8, (1, 1))
        assert n_s == want, (switch, n_s)
        switch_launches[switch] = n_s
        m_k, g_k = default_step[1]
        emit({"phase": "train_step_switch_vs_default", "switch": switch,
              "hw": [256, 256], "batch": 8, "dtype": "float32", "flag": 1,
              "max_loss_rel_diff": losses_agree(m_s, m_k),
              "grad_err": grad_errors(g_s, g_k), "grad_tol": GRAD_TOL,
              "launches": n_s})
    # the same step with the attention's query patches in two shards on
    # this card (attention_impl='sharded'), by default and under the split
    # switch: each kernel launches once per shard; gradients against the
    # default kernels' unsharded step
    for switch, want in ((None, expect(fwd=4, fwd_lse=2, bwd=2)),
                         ("SKETCHEDIT_SPLIT_DKDV",
                          expect(fwd=4, fwd_lse=2, dq=2, dv=2, dk=2))):
        with env(**({switch: "1"} if switch else {})):
            m_s, g_s, n_s = one_step("float32", "sharded", batch8, (1, 1))
        assert n_s == want, (switch, n_s)
        for k, v in n_s.items():
            multi_launches[k] += v
        m_k, g_k = default_step[1]
        emit({"phase": "sharded_attention", "path": "train_step",
              "switch": switch, "hw": [256, 256], "batch": 8,
              "dtype": "float32", "flag": 1, "shards": 2,
              "max_loss_rel_diff": losses_agree(m_s, m_k),
              "grad_err": grad_errors(g_s, g_k), "grad_tol": GRAD_TOL,
              "launches": n_s})
    del default_step
    # and in bfloat16 under the split switch: launch counts, finite losses
    with env(SKETCHEDIT_SPLIT_DKDV="1"):
        m_s, _, n_s = one_step("bfloat16", "kernel", batch8, (1, 1))
    assert n_s == expect(fwd=2, fwd_lse=1, dq=1, dv=1, dk=1), n_s
    assert all(np.isfinite(v) for v in m_s.values()), m_s
    switch_launches["SKETCHEDIT_SPLIT_DKDV[bf16]"] = n_s
    emit({"phase": "train_step_switch", "switch": "SKETCHEDIT_SPLIT_DKDV",
          "dtype": "bfloat16", "losses": m_s, "launches": n_s})

    # bfloat16: both paths held to the float32 dense step's generator
    # gradients; the kernel path's error may exceed the dense path's by 5%
    _, g_ref, _ = one_step("float32", "dense", batch8, (1, 1))
    gen_ref = {k: v for k, v in g_ref.items() if not k.startswith("D.")}
    bf = {}
    for impl in ("kernel", "dense"):
        m_b, g_b, _ = one_step("bfloat16", impl, batch8, (1, 1))
        assert all(np.isfinite(v) for v in m_b.values()), m_b
        num = sum(((g_b[k] - w) ** 2).sum().item() for k, w in gen_ref.items())
        den = sum((w ** 2).sum().item() for w in gen_ref.values())
        bf[impl] = (num / den) ** 0.5
    emit({"phase": "train_step_bf16_vs_f32", "hw": [256, 256], "batch": 8,
          "flag": 1, "grad_rel_l2_err_kernel": bf["kernel"],
          "grad_rel_l2_err_dense": bf["dense"]})
    assert bf["kernel"] <= 1.05 * bf["dense"], bf

    # the same step on the GPU and on the CPU (64^2, B = 2; the CPU takes
    # the kernels' plain versions)
    batch2 = train_batch(2, 64, args.seed + 300)
    m_g, g_g, _ = one_step("float32", "kernel", batch2, (0, 1))
    m_c, g_c, _ = one_step("float32", "kernel", batch2, (0, 1), device="cpu")
    loss_diff = losses_agree(m_g, m_c)
    worst = grad_errors(g_g, g_c)
    emit({"phase": "train_step_gpu_vs_cpu", "hw": [64, 64], "batch": 2,
          "max_loss_rel_diff": loss_diff, "grad_err": worst,
          "grad_tol": GRAD_TOL})

    # 6. training path -----------------------------------------------------
    from PIL import Image
    from sketchedit_tpu_torch import data as data_mod
    pngs = os.path.join(tmp.name, "train_images")
    os.makedirs(pngs)
    r = np.random.RandomState(args.seed + 400)
    for i in range(24):
        arr = (r.rand(256, 256, 3) * 255).astype(np.uint8)
        arr[r.randint(0, 200):, r.randint(0, 200):] //= 3   # some edges
        Image.fromarray(arr).save(os.path.join(pngs, f"{i:03d}.png"))
    ns = argparse.Namespace(
        train_image_dir=pngs, train_image_list=None,
        preprocess_mode="resize_and_crop", load_size=256, crop_size=256,
        aspect_ratio=1.0, isTrain=True, no_flip=False, canny_low=100,
        canny_high=200, decode_cache_mb=512, not_om=True, cjit=None,
        batchSize=8, serial_batches=False, dataset_mode="editimage",
        nThreads=0, checkpoints_dir=os.path.join(tmp.name, "train_ck"),
        name="smoke")
    with contextlib.redirect_stdout(io.StringIO()):
        loader = data_mod.create_dataloader(ns)
    assert len(loader) == 3
    train_launches = {}
    for dt in ("float32", "bfloat16"):
        state, cfg = train_state(dt, "auto")
        start = {label: {k: v.detach().clone() for k, v in
                         net.state_dict().items()}
                 for label, net in state.nets.items()}
        seen = []
        t0 = time.perf_counter()
        zero_counts(attention_cuda)
        train_loop(state, loader, cfg, on_step=seen.append)
        torch.cuda.synchronize()
        used = counts(attention_cuda)
        loop_s = time.perf_counter() - t0
        assert len(seen) == 3 and state.step == 3
        assert used == expect(fwd=6, fwd_lse=3, bwd=3), used
        train_launches[dt] = used
        losses = [{k: float(v) for k, v in m.items()} for m in seen]
        assert all(np.isfinite(v) for m in losses for v in m.values())
        unchanged = [f"{label}.{k}" for label, net in state.nets.items()
                     for k, v in net.state_dict().items()
                     if torch.equal(v, start[label][k])]
        assert not unchanged, unchanged
        # a saved checkpoint reloads and gives the same forward
        ckpt.save_pipeline(state.nets, f"smoke_{dt}", ns)
        fresh, _ = train_state(dt, "auto")
        for label in ("M", "G", "D"):
            fresh.nets[label].load_state_dict(ckpt.load_network_path(
                ckpt.net_path(ns.checkpoints_dir, ns.name, label,
                              f"smoke_{dt}", ".npz")), strict=True)
        tb = tr.decompress_batch(tr.batch_to_device(next(iter(loader)), dev))
        with torch.no_grad():
            outs = [tr.generate_fake_train(s.nets["M"], s.nets["G"], tb, 2,
                                           cfg)["fake"] for s in (state, fresh)]
        assert torch.equal(outs[0], outs[1]), "reloaded checkpoint differs"
        emit({"phase": "train_loop", "hw": [256, 256], "batch": 8,
              "dtype": dt, "steps": 3, "seconds": round(loop_s, 3),
              "launches": used, "first_losses": losses[0],
              "last_losses": losses[-1], "params_changed": True,
              "checkpoint_reloads": True})

    # held-out validation in process: 8 of the PNGs at 256^2 scored through
    # netM and netG of a float32 train state, once with the kernel path and
    # once with a dense netG carrying the same weights; netM is shared, so
    # the hard masks and mask_iou agree exactly
    from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillC2Generator
    from sketchedit_tpu_torch.options.train_options import TrainOptions
    from sketchedit_tpu_torch.train.validation import Validator
    with contextlib.redirect_stdout(io.StringIO()):
        vopt = parse_argv(TrainOptions, [
            "--name", "val", "--checkpoints_dir", ns.checkpoints_dir,
            "--dataset_mode", "editimage", "--train_image_dir", pngs,
            "--val_image_dir", pngs, "--preprocess_mode", "resize_and_crop",
            "--load_size", "256", "--crop_size", "256", "--not_om"],
            save=False)
    state, cfg = train_state("float32", "kernel")
    validator = Validator(vopt, cfg, pngs, items=8)
    assert validator.image.shape == (8, 256, 256, 3)
    dense_g = DeepFillC2Generator(DeepFillConfig(attention_impl="dense"),
                                  device=dev)
    dense_g.load_state_dict(state.nets["G"].state_dict())
    saved = counts(attention_cuda)
    zero_counts(attention_cuda)
    val_k = validator.run(state.nets)
    torch.cuda.synchronize()
    val_launches = counts(attention_cuda)
    # one eval-mode edit of the 8 items: one forward launch, as one edit
    assert val_launches == expect(fwd=1), val_launches
    val_d = validator.run({"M": state.nets["M"], "G": dense_g})
    assert counts(attention_cuda) == val_launches, "the dense path launched"
    val_diff = {k: abs(val_k[k] - val_d[k]) for k in val_k}
    for k, v in val_k.items():
        assert np.isfinite(v), (k, v)
        tol = {"psnr": 1e-3, "region_psnr": 1e-3, "mask_iou": 0.0}.get(
            k, 1e-5)
        assert val_diff[k] <= tol, (k, val_k[k], val_d[k])
    assert 0.0 < val_k["mask_iou"] < 1.0, val_k
    val_ms = cuda_ms(lambda: validator.run(state.nets), reps=5, warmup=1)
    # where a call's time goes: the eval edit of the 8 items, then the
    # metrics on its outputs
    from types import SimpleNamespace
    from sketchedit_tpu_torch.models.editline2 import edit
    from sketchedit_tpu_torch.utils import metrics as metrics_mod
    view = SimpleNamespace(config=validator.config, netM=state.nets["M"],
                           netG=state.nets["G"])
    v_img, v_sk, v_reg = (torch.from_numpy(a).to(dev) for a in (
        validator.image, validator.sketch, validator.region))
    with torch.no_grad():
        edit_ms = cuda_ms(lambda: edit(view, v_img, v_sk), reps=5, warmup=1)
        v_out, _ = edit(view, v_img, v_sk)
        ssim_ms = cuda_ms(lambda: metrics_mod.ssim(v_out, v_img), reps=5,
                          warmup=1)
    set_counts(attention_cuda, saved)
    emit({"phase": "train_validation", "hw": [256, 256], "items": 8,
          "dtype": "float32", "kernel": val_k, "dense": val_d,
          "abs_diff": val_diff, "launches": val_launches,
          "ms_per_call": val_ms, "edit_ms": edit_ms, "ssim_ms": ssim_ms,
          **card})
    del state, dense_g

    # the train CLI on the same PNGs: 16 images, B = 8, two steps
    cli_pngs = os.path.join(tmp.name, "cli_images")
    os.makedirs(cli_pngs)
    for name in sorted(os.listdir(pngs))[:16]:
        os.link(os.path.join(pngs, name), os.path.join(cli_pngs, name))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "sketchedit_tpu_torch.cli.train", "--name",
         "cli", "--checkpoints_dir", os.path.join(tmp.name, "cli_ck"),
         "--dataset_mode", "editimage", "--train_image_dir", cli_pngs,
         "--batchSize", "8", "--niter", "1", "--use_cam", "--pool_type",
         "max", "--joint_train_inp", "--not_om", "--preprocess_mode",
         "resize_and_crop", "--load_size", "256", "--crop_size", "256",
         "--save_epoch_freq", "1", "--print_freq", "8", "--device", "cuda"],
        cwd=ROOT, check=True, timeout=600, capture_output=True, text=True)
    assert res.stdout.count(" ms/img) {") == 2, res.stdout[-2000:]
    files = set(os.listdir(os.path.join(tmp.name, "cli_ck", "cli")))
    assert {"latest_net_M.npz", "latest_net_G.npz", "latest_net_D.npz",
            "train_state_latest.pt", "iter.txt"} <= files, files
    emit({"phase": "train_cli", "images": 16, "batch": 8, "steps": 2,
          "seconds": round(time.perf_counter() - t0, 3)})

    # the train CLI with held-out validation and the spawned loader pool:
    # 2 epochs of 2 steps, a validation after each, best_net_* and the
    # metrics log
    t0 = time.perf_counter()
    run_dir = os.path.join(tmp.name, "cli_ck", "cli_val")
    res = subprocess.run(
        [sys.executable, "-m", "sketchedit_tpu_torch.cli.train", "--name",
         "cli_val", "--checkpoints_dir", os.path.join(tmp.name, "cli_ck"),
         "--dataset_mode", "editimage", "--train_image_dir", cli_pngs,
         "--val_image_dir", pngs, "--val_items", "8", "--nThreads", "2",
         "--batchSize", "8", "--niter", "2", "--use_cam", "--pool_type",
         "max", "--joint_train_inp", "--not_om", "--preprocess_mode",
         "resize_and_crop", "--load_size", "256", "--crop_size", "256",
         "--save_epoch_freq", "1", "--print_freq", "8", "--device", "cuda"],
        cwd=ROOT, timeout=600, capture_output=True, text=True)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    assert "loader: processes, nThreads 2" in res.stdout, res.stdout[-2000:]
    with open(os.path.join(run_dir, "metrics.jsonl")) as fh:
        rows = [json.loads(ln) for ln in fh]
    assert [(r["kind"], r["epoch"]) for r in rows] == [
        ("train", 1), ("train", 1), ("val", 1),
        ("train", 2), ("train", 2), ("val", 2)], rows
    val_rows = [r for r in rows if r["kind"] == "val"]
    assert all(np.isfinite(r[k]) for r in val_rows for k in val_k)
    assert val_rows[0]["best"] is True
    files = set(os.listdir(run_dir))
    assert {"best_net_M.npz", "best_net_G.npz", "best_net_D.npz"} <= files
    emit({"phase": "train_cli_val", "images": 16, "val_items": 8,
          "batch": 8, "epochs": 2, "nThreads": 2, "val_rows": val_rows,
          "seconds": round(time.perf_counter() - t0, 3)})

    # 6b. data parallelism on this card -----------------------------------
    # Two replicas and two ranks share cuda:0: the runs show that each path
    # computes what the single-device path computes through the kernels;
    # their times measure overhead, not scaling. NCCL refuses two ranks on
    # one card, so the two ranks talk over gloo, and one rank alone sets
    # NCCL up on the card.
    from sketchedit_tpu_torch.parallel import distributed

    # dp_edit: build_pipeline with --data_parallel 2 --gpu_ids 0,0 on the
    # float32 pipeline's (scaled) weights, B = 5 (padded to 6, shards of
    # 3), against the single-device pipeline fed the same shards, and
    # reported against it on the whole batch (other batch sizes may take
    # other cuDNN algorithms)
    dp_ck = os.path.join(tmp.name, "dp_ck")
    ckpt.save_pipeline({"M": pipes["float32"].model.netM,
                        "G": pipes["float32"].model.netG}, "latest",
                       argparse.Namespace(checkpoints_dir=dp_ck, name="celeb"))
    with contextlib.redirect_stdout(io.StringIO()):
        dp_pipe = build_pipeline(parse_argv(TestOptions, [
            "--name", "celeb", "--checkpoints_dir", dp_ck, "--use_cam",
            "--pool_type", "max", "--joint_train_inp", "--device", "cuda",
            "--compute_dtype", "float32", "--data_parallel", "2",
            "--gpu_ids", "0,0"]), require_checkpoint=True)
    assert [d for _, d in dp_pipe.replicas] == list(SHARDS)
    one = pipes["float32"]
    img, sk = batch(5, 256, 256, args.seed + 600)
    zero_counts(attention_cuda)
    dp_c, dp_m = dp_pipe(img, sk)
    torch.cuda.synchronize()
    used = counts(attention_cuda)
    assert used == expect(fwd=2), used        # one launch per replica
    multi_launches["fwd"] += used["fwd"]
    pad = lambda a: np.concatenate([a[3:], a[-1:]])    # noqa: E731
    shard_c = np.concatenate([one(img[:3], sk[:3])[0],
                              one(pad(img), pad(sk))[0][:2]])
    whole_c, whole_m = one(img, sk)
    row = {"phase": "dp_edit", "batch": 5, "replicas": 2, "hw": [256, 256],
           "dtype": "float32", "launches": used,
           "max_u8_diff_vs_shards_alone": int(u8_diff(dp_c, shard_c).max()),
           "max_u8_diff_vs_whole_batch": int(u8_diff(dp_c, whole_c).max()),
           "mask_equal_whole_batch": bool((dp_m == whole_m).all()),
           "dp_ms_per_batch": cuda_ms(lambda: dp_pipe(img, sk), reps=5),
           "single_ms_per_batch": cuda_ms(lambda: one(img, sk), reps=5),
           "note": "two replicas on one card: overhead, not scaling", **card}
    emit(row)
    assert dp_c.shape == img.shape and dp_m.shape == (5, 256, 256, 1)
    assert row["max_u8_diff_vs_shards_alone"] <= 1, row
    del dp_pipe

    # dp_train_cli: --data_parallel 2 --gpu_ids 0,0 on the 16 PNGs at B = 8
    # (2 steps an epoch), started here to run beside dp_train_step; after
    # epoch 1's checkpoint the session's process group gets SIGTERM: both
    # ranks stop after the same step, exit 143, and rank 0 alone wrote
    # every file once
    t_cli = time.perf_counter()
    dp_run = os.path.join(tmp.name, "cli_ck", "dp_cli")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sketchedit_tpu_torch.cli.train", "--name",
         "dp_cli", "--checkpoints_dir", os.path.join(tmp.name, "cli_ck"),
         "--dataset_mode", "editimage", "--train_image_dir", cli_pngs,
         "--batchSize", "8", "--niter", "100", "--use_cam", "--pool_type",
         "max", "--joint_train_inp", "--not_om", "--preprocess_mode",
         "resize_and_crop", "--load_size", "256", "--crop_size", "256",
         "--save_epoch_freq", "1", "--print_freq", "8", "--device", "cuda",
         "--data_parallel", "2", "--gpu_ids", "0,0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    cli_out = []

    def stop_after_epoch_1():
        for line in proc.stdout:
            cli_out.append(line)
            if line.startswith("saved the model at the end of epoch 1"):
                os.killpg(proc.pid, signal.SIGTERM)

    watcher = threading.Thread(target=stop_after_epoch_1, daemon=True)
    watcher.start()

    try:
        # dp_train_step: two gloo ranks on this card, 4 rows each of the
        # global B = 8 batch, one step at lr 0 (float32, TF32 off): averaged
        # gradients and losses against the single-process steps on the same
        # halves (DP_GRAD_TOL), and the whole batch's step (reported; losses
        # held to 1e-4)
        dp_dir = os.path.join(tmp.name, "dp_step")
        os.makedirs(dp_dir)
        np.savez(os.path.join(dp_dir, "batch.npz"), **batch8)
        ctx = multiprocessing.get_context("spawn")
        init_method = distributed.free_tcp_address()
        t0 = time.perf_counter()
        ranks = [ctx.Process(target=dp_rank, args=(
            r, 2, init_method, os.path.join(dp_dir, "batch.npz"),
            os.path.join(dp_dir, f"rank{r}.npz"), args.seed))
            for r in range(2)]
        for p in ranks:
            p.start()

        def single_step(rows=batch8, group=None):
            """The single-process step as dp_rank takes it (seed, lr 0, flags
            1, 1) on ``rows``; its gradients and metrics."""
            cfg = tr.TrainConfig(netg=DeepFillConfig(attention_impl="kernel"),
                                 precision="highest", lr=0.0)
            state = tr.init_train_state(cfg, seed=args.seed, device="cuda")
            scale_weights_(state.nets["M"], state.nets["G"])
            if group is not None:
                distributed.broadcast_(distributed.train_state_tensors(state))
            _, metrics = tr.train_step(state, tr.batch_to_device(rows, dev),
                                       1, 1, cfg, group=group)
            return ({f"{label}.{n}": p.grad.detach().clone()
                     for label, net in state.nets.items()
                     for n, p in net.named_parameters()},
                    {k: float(v) for k, v in metrics.items()})

        def dp_errors(grads, metrics, want_grads, want_metrics, check=True):
            """Per net the worst relative L2 error of its gradient tensors
            (with ``check``, each held to DP_GRAD_TOL; a zero tensor by its
            max |error|), and the worst relative error of the losses (held
            to 1e-4)."""
            worst = {}
            for k, w in want_grads.items():
                d = grads[k].to(w.device) - w
                norm = w.norm().item()
                l2 = d.norm().item() / norm if norm else d.abs().max().item()
                net = k.split(".")[0]
                worst[net] = max(worst.get(net, 0.0), l2)
                assert l2 <= DP_GRAD_TOL or not check, (k, l2)
            rel = max(abs(metrics[k] - v) / max(abs(v), 1e-12)
                      for k, v in want_metrics.items())
            assert rel <= 1e-4, (metrics, want_metrics)
            return worst, rel

        # the references, in this process while the ranks run
        g_one, m_one = single_step()
        halves = [single_step({k: v[i * 4:(i + 1) * 4]
                               for k, v in batch8.items()}) for i in range(2)]
        g_halves = {k: (halves[0][0][k] + halves[1][0][k]) / 2 for k in g_one}
        m_halves = {k: (halves[0][1][k] + halves[1][1][k]) / 2 for k in m_one}
        for p in ranks:
            p.join(600)
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in ranks]
        assert codes == [0, 0], codes
        ranks_s = time.perf_counter() - t0
        r0, r1 = (dict(np.load(os.path.join(dp_dir, f"rank{r}.npz")))
                  for r in range(2))
        for k in r0:
            assert np.array_equal(r0[k], r1[k]), f"ranks disagree on {k}"
        rank_counts = {k[6:]: int(v) for k, v in r0.items()
                       if k.startswith("count.")}
        assert rank_counts == expect(fwd=2, fwd_lse=1, bwd=1), (
            rank_counts)
        for k, v in rank_counts.items():
            multi_launches[k] += 2 * v          # each rank's own launches
        g_dp = {k: torch.from_numpy(r0[f"grad.{k}"]) for k in g_one}
        m_dp = {k: float(r0[f"metric.{k}"]) for k in m_one}
        worst_l2, loss_rel = dp_errors(g_dp, m_dp, g_halves, m_halves)
        whole_l2, whole_loss_rel = dp_errors(g_dp, m_dp, g_one, m_one,
                                             check=False)
        del halves, g_halves

        # one rank under NCCL (world of 1): its set-up, the broadcast and the
        # all_reduce run on the card, and the step equals the one without group
        host = distributed.init(0, 1, "nccl", distributed.free_tcp_address())
        try:
            assert torch.distributed.get_backend() == "nccl"
            zero_counts(attention_cuda)
            g_nccl, m_nccl = single_step(group=torch.distributed.group.WORLD)
            torch.cuda.synchronize()
            nccl_counts = counts(attention_cuda)
            assert distributed.agree_max(3, host) == 3
        finally:
            distributed.close()
        assert nccl_counts == expect(fwd=2, fwd_lse=1, bwd=1), (
            nccl_counts)
        for k, v in nccl_counts.items():
            multi_launches[k] += v
        nccl_l2, nccl_rel = dp_errors(g_nccl, m_nccl, g_one, m_one)
        emit({"phase": "dp_train_step", "ranks": 2, "backend": "gloo",
              "batch": 8, "hw": [256, 256], "dtype": "float32", "tf32": False,
              "grad_rel_l2_max_vs_halves": worst_l2, "grad_tol": DP_GRAD_TOL,
              "loss_rel_diff_max_vs_halves": loss_rel, "loss_rtol": 1e-4,
              "grad_rel_l2_max_vs_whole_batch": whole_l2,
              "loss_rel_diff_max_vs_whole_batch": whole_loss_rel,
              "rank_launches": rank_counts, "ranks_seconds": round(ranks_s, 3),
              "nccl_rank": {"world": 1, "launches": nccl_counts,
                            "grad_rel_l2_max": nccl_l2,
                            "loss_rel_diff_max": nccl_rel}})
        del g_one, g_nccl

    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)      # no process outlives this
        raise

    watcher.join(600)
    try:
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    out = "".join(cli_out)
    assert rc == 128 + signal.SIGTERM, (rc, out[-3000:])
    assert "data-parallel over 2 ranks: cuda:0, cuda:0" in out, out[-3000:]
    for once in ("epoch 1 iter 8 ", "epoch 1 iter 16 ",
                 "saved the model at the end of epoch 1",
                 "checkpointed on signal 15; exiting"):
        assert out.count(once) == 1, (once, out[-3000:])
    files = set(os.listdir(dp_run))
    for label in "MGD":
        assert {f"1_net_{label}.npz", f"latest_net_{label}.npz"} <= files
    assert {"train_state_latest.pt", "iter.txt", "metrics.jsonl"} <= files
    with open(os.path.join(dp_run, "metrics.jsonl")) as fh:
        rows = [(r["epoch"], r["iter"]) for r in map(json.loads, fh)]
    assert len(rows) == len(set(rows)) and rows[:2] == [(1, 8), (1, 16)], rows
    emit({"phase": "dp_train_cli", "ranks": 2, "gpu_ids": [0, 0],
          "batch": 8, "steps_logged": len(rows), "exit_code": rc,
          "files": sorted(files),
          "seconds": round(time.perf_counter() - t_cli, 3)})

    # 7. CLI --------------------------------------------------------------
    work = os.path.join(tmp.name, "cli")
    for d in ("images", "edges"):
        os.makedirs(os.path.join(work, d))
    names = ["pair0", "pair1"]
    r = np.random.RandomState(args.seed + 7)
    for n in names:
        Image.fromarray(r.randint(0, 256, (256, 256, 3)).astype(np.uint8)
                        ).save(os.path.join(work, "images", f"{n}.png"))
        Image.fromarray(((r.rand(256, 256) > 0.92) * 255).astype(np.uint8)
                        ).save(os.path.join(work, "edges", f"{n}.png"))
    with open(os.path.join(work, "list.txt"), "w") as fh:
        fh.write("".join(f"{n}.png\n" for n in names))
    out_dir = os.path.join(work, "results")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "sketchedit_tpu_torch.cli.infer",
                    *CELEB_FLAGS, "--image_dirs", os.path.join(work, "images"),
                    "--mask_dirs", os.path.join(work, "edges"),
                    "--image_lists", os.path.join(work, "list.txt"),
                    "--output_dir", out_dir, "--checkpoints_dir",
                    os.path.join(work, "empty_ck"), "--device", "cuda"],
                   cwd=ROOT, check=True, timeout=600,
                   stdout=subprocess.DEVNULL)
    for n in names:
        arr = np.asarray(Image.open(os.path.join(out_dir, f"{n}.png")))
        assert arr.shape == (256, 256, 3), arr.shape
    emit({"phase": "cli", "images": len(names),
          "seconds": round(time.perf_counter() - t0, 3)})

    # 8. serving ------------------------------------------------------------
    from sketchedit_tpu_torch.cli.demo import DemoOptions
    from sketchedit_tpu_torch.cli.serve import ApiOptions
    from sketchedit_tpu_torch.server import rawproto
    from sketchedit_tpu_torch.server.demo_server import DemoApp
    from sketchedit_tpu_torch.server.demo_server import serve as demo_serve
    from sketchedit_tpu_torch.server.executor import (
        _BUCKETS, BatchingExecutor)

    # the servers load the float32 pipeline's (scaled) weights from disk
    serve_ck = os.path.join(tmp.name, "serve_ck")
    ck_ns = argparse.Namespace(checkpoints_dir=serve_ck, name="celeb")
    ckpt.save_pipeline({"M": pipes["float32"].model.netM,
                        "G": pipes["float32"].model.netG}, "latest", ck_ns)

    def serve_pipeline(options_cls, *extra):
        """The pipeline a server builds from test_celeb.sh's model flags:
        serve defaults (bfloat16, TF32 allowed) unless ``extra`` says
        otherwise. build_pipeline sets the process-wide TF32 switches."""
        with contextlib.redirect_stdout(io.StringIO()):
            opt = parse_argv(options_cls, [*SERVE_FLAGS, "--checkpoints_dir",
                                           serve_ck, *extra])
            return opt, build_pipeline(opt, require_checkpoint=True)

    F32 = ("--compute_dtype", "float32", "--precision", "highest")

    def settled(executor, n_served):
        """stats() once ``n_served`` requests are counted: the counters
        land after the futures resolve, so readers poll."""
        deadline = time.time() + 30
        while True:
            stats = executor.stats()
            if stats["requests_served"] >= n_served:
                return stats
            assert time.time() < deadline, stats
            time.sleep(0.005)

    def served(pipeline, requests, max_batch, clients=None):
        """Warm an executor, then send every request through it from
        ``clients`` threads (one per request unless given); (results, stats,
        launches, seconds, latencies in ms). ``batches_after_warmup`` counts
        the batches of the requests alone."""
        executor = BatchingExecutor(pipeline, max_batch=max_batch,
                                    max_wait_ms=20)
        clients = clients or len(requests)
        out = [None] * len(requests)
        latency = [None] * len(requests)

        def client(c):
            for i in range(c, len(requests), clients):
                t0 = time.perf_counter()
                out[i] = executor.submit(*requests[i]).result(timeout=300)
                latency[i] = (time.perf_counter() - t0) * 1e3
        try:
            executor.warmup(requests[0][0].shape[:2], timeout=300)
            n_warm = sum({b for b in _BUCKETS if b <= max_batch}
                         | {max_batch})
            warm = settled(executor, n_warm)["batches_dispatched"]
            zero_counts(attention_cuda)
            threads = [threading.Thread(target=client, args=(c,))
                       for c in range(clients)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            seconds = time.perf_counter() - t0
            stats = settled(executor, n_warm + len(requests))
            stats["batches_after_warmup"] = stats["batches_dispatched"] - warm
            return out, stats, counts(attention_cuda), seconds, latency
        finally:
            executor.shutdown()

    def requests_at(hw, n, seed):
        img, sk = batch(n, hw, hw, seed)
        return [(img[i], sk[i]) for i in range(n)]

    def rows_alone(pipe, images, sketches, composed):
        """A batch's rows against B = 1 calls, stage by stage, on this thread
        and the default kernel. netM on the batch and on each row alone:
        how far the soft masks differ, and how many pixels of the hard mask
        (soft > 0.5) flip for it. Then each row alone through netG, fed the
        hard mask the batch gave that row, and the composite: how far
        ``composed`` (the batch's uint8 result) is from it. Returns the
        numbers and, per row, whether the two hard masks agree."""
        model, dt = pipe.model, pipe.config.dtype
        thr = pipe.config.mask_threshold
        soft_diff = margin = 0.0
        worst = flips = 0
        agree = []
        with torch.inference_mode():
            x = torch.from_numpy(images).to(dev).permute(0, 3, 1, 2).to(
                dt) / 127.5 - 1.0
            s_ = (torch.from_numpy(sketches).to(dev).permute(0, 3, 1, 2)
                  > 0).to(dt)
            soft_b = model.netM(x, s_)[0]
            for r in range(x.shape[0]):
                xr, sr, sb = x[r:r + 1], s_[r:r + 1], soft_b[r:r + 1]
                soft_1 = model.netM(xr, sr)[0]
                soft_diff = max(soft_diff,
                                (soft_1 - sb).abs().max().item())
                flipped = (soft_1 > thr) != (sb > thr)
                n_flipped = int(flipped.sum().item())
                flips += n_flipped
                agree.append(n_flipped == 0)
                if n_flipped:
                    margin = max(margin,
                                 (soft_1[flipped] - thr).abs().max().item())
                hard = (sb > thr).to(dt)
                fake = model.netG(xr, xr, hard, hard, sr)[1]
                one = fake * soft_1 + xr * (1.0 - soft_1)
                one = torch.round((torch.clamp(one, -1, 1) + 1.0) * 127.5
                                  ).to(torch.uint8).permute(0, 2, 3, 1)
                worst = max(worst, int(u8_diff(one[0].cpu().numpy(),
                                               composed[r]).max()))
        return {"max_u8_diff_vs_alone_given_batch_hard_mask": worst,
                "netM_soft_mask_max_abs_diff_vs_alone": soft_diff,
                "hard_mask_pixels_flipped_vs_alone": flips,
                "frac_hard_mask_pixels_flipped_vs_alone":
                    flips / float(soft_b.numel()),
                "flipped_pixels_max_distance_from_threshold": margin,
                "rows": len(agree), "rows_hard_masks_agree": sum(agree)}, agree

    # A served row and a B = 1 call of the same image need not agree: the
    # hard mask is netM's soft mask cut at 0.5, attention spreads one flipped
    # pixel of it over the whole hole, and cuDNN picks its algorithms by
    # batch size. So in float32 every served batch is taken apart by
    # rows_alone: each row is held to 1 LSB of the B = 1 pipeline fed the
    # hard mask the batch gave it, the soft masks must agree to SOFT_TOL,
    # and a request whose two hard masks agree is held to 1 LSB of the
    # B = 1 pipeline as it is. A fault that couples rows of a batch (the
    # padding, a reduction across the batch) fails these checks; the same
    # numbers through the dense attention, where no kernel runs, stand
    # beside. bfloat16 is held to the pipeline alone on the same batch.
    SOFT_TOL = 5e-3     # 9.6e-4 at worst on an H100 80GB HBM3
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img32 = np.stack([r[0] for r in requests_at(256, 32, args.seed + 500)])
    sk32 = np.stack([r[1] for r in requests_at(256, 32, args.seed + 500)])
    for impl, p in (("kernel", pipes["float32"]), ("dense", dense["float32"])):
        together = p(img32, sk32)[0]
        apart = np.concatenate([p(img32[i:i + 1], sk32[i:i + 1])[0]
                                for i in range(32)])
        effect, _ = rows_alone(p, img32, sk32, together)
        emit({"phase": "batch_size_effect", "attention": impl,
              "dtype": "float32", "hw": [256, 256], "batch": 32,
              "frac_pixels_off_by_more_than_1_vs_one_by_one":
                  float((u8_diff(together, apart) > 1).mean()),
              "max_u8_diff_vs_one_by_one":
                  int(u8_diff(together, apart).max()), **effect, **card})
        assert effect["max_u8_diff_vs_alone_given_batch_hard_mask"] <= 1
        assert effect["netM_soft_mask_max_abs_diff_vs_alone"] <= SOFT_TOL
    del img32, sk32, together, apart
    serve_launches = {}
    reqs256 = requests_at(256, 32, args.seed + 500)
    reqs512 = requests_at(512, 8, args.seed + 501)
    for dt, extra in (("float32", F32), ("bfloat16", ())):
        _, pipe = serve_pipeline(ApiOptions, *extra)
        assert pipe.config.compute_dtype == dt
        alone = {256: [pipe(i[None], s[None]) for i, s in reqs256],
                 512: [pipe(i[None], s[None]) for i, s in reqs512]}
        for switch, kernel, hw, reqs in (
                (None, "fwd", 256, reqs256),
                ("SKETCHEDIT_SHARED_ATTN", "shared", 256, reqs256),
                ("SKETCHEDIT_DSPLIT_ATTN", "dsplit", 256, reqs256),
                ("SKETCHEDIT_DSPLIT_ATTN", "dsplit", 512, reqs512)):
            max_batch = 32 if hw == 256 else 8
            rec = Recorded(pipe)
            with env(**({switch: "1"} if switch else {})):
                out, stats, used, _, _ = served(rec, reqs, max_batch)
            n_batches = stats["batches_after_warmup"]
            assert all(o is not None for o in out)
            assert stats["batch_errors"] == 0, stats
            assert n_batches < len(reqs), "nothing was coalesced"
            # one forward launch per dispatched batch, by the chosen kernel
            assert used == expect(**{kernel: n_batches}), (used, n_batches)
            calls = rec.calls[len(rec.calls) - n_batches:]
            # every caller got the row of its own image, bit for bit
            rows = {}
            for c, (images, _, _) in enumerate(calls):
                for r in range(images.shape[0]):
                    rows.setdefault(images[r].tobytes(), (c, r))
            for (img, _), o in zip(reqs, out):
                c, r = rows[img.tobytes()]
                assert o[0].shape == (hw, hw, 3) and o[0].dtype == np.uint8
                assert o[1].shape == (hw, hw, 1)
                assert np.array_equal(o[0], calls[c][2][0][r])
                assert np.array_equal(o[1], calls[c][2][1][r])
            # each batch again through the pipeline alone, on this thread
            # and the default kernel
            worst, means = 0, []
            for images, sketches, (composed, mask) in calls:
                ref_c, ref_m = pipe(images, sketches)
                worst = max(worst, u8_diff(composed, ref_c).max(),
                            u8_diff(mask, ref_m).max())
                means.append(u8_diff(composed, ref_c).mean())
            one_by_one = [u8_diff(o[0], a[0][0]) for o, a in zip(out,
                                                                alone[hw])]
            effect = {}
            if dt == "float32":
                agreeing = 0
                parts = [rows_alone(pipe, im, sk, c)
                         for im, sk, (c, _) in calls]
                for k in parts[0][0]:
                    effect[k] = (max if "max" in k else sum)(
                        e[k] for e, _ in parts)
                effect["frac_hard_mask_pixels_flipped_vs_alone"] = (
                    effect["hard_mask_pixels_flipped_vs_alone"]
                    / float(effect["rows"] * hw * hw))
                for (img, _), d in zip(reqs, one_by_one):
                    c, r = rows[img.tobytes()]
                    if parts[c][1][r]:
                        agreeing += 1
                        assert d.max() <= 1, (switch, hw, int(d.max()))
                effect["requests_hard_masks_agree_held_to_one_by_one"] = (
                    agreeing)
            emit({"phase": "serving_in_process", "dtype": dt,
                  "switch": switch, "kernel": kernel, "hw": [hw, hw],
                  "requests": len(reqs), "max_batch": max_batch,
                  "batches": n_batches,
                  "batch_size_histogram": stats["batch_size_histogram"],
                  "launches": used,
                  "max_u8_diff_vs_pipeline_alone_same_batch": int(worst),
                  "mean_u8_diff_vs_pipeline_alone_same_batch":
                      float(np.mean(means)),
                  "max_u8_diff_vs_one_by_one":
                      int(max(d.max() for d in one_by_one)),
                  "frac_pixels_off_by_more_than_1_vs_one_by_one":
                      float(np.mean([(d > 1).mean() for d in one_by_one])),
                  **effect, "dispatch_ms": stats["dispatch_ms"],
                  "assemble_ms": stats["assemble_ms"],
                  "scatter_ms": stats["scatter_ms"], **card})
            if dt == "float32":
                assert worst <= 1, (switch, hw, worst)
                assert effect[
                    "max_u8_diff_vs_alone_given_batch_hard_mask"] <= 1, (
                        switch, hw)
                assert effect[
                    "netM_soft_mask_max_abs_diff_vs_alone"] <= SOFT_TOL
            else:
                # bfloat16: the kernels' summation orders flip roundings,
                # which the bf16 convs amplify to several LSB
                assert np.mean(means) < 1.0, (switch, hw, np.mean(means))
            serve_launches[(kernel, hw, dt)] = used[kernel]
        if dt == "float32":
            f32_pipe = pipe
        del pipe, rec, calls
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # the serve CLI as a subprocess: float32 under the D-split switch at
    # 512^2, serve defaults (bfloat16) under the shared switch at 256^2
    def png_b64(arr):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    def bucket_references(pipeline, reqs):
        """Per request, the pipeline's answer alone (B = 1) and as a row of
        the batch of eight: the two batch sizes a --max_batch 8 server
        dispatches (see the note on batch size above)."""
        stack = pipeline(np.stack([r[0] for r in reqs[:8]]),
                         np.stack([r[1] for r in reqs[:8]]))
        return [[pipeline(img[None], sk[None]),
                 (stack[0][i:i + 1], stack[1][i:i + 1])]
                for i, (img, sk) in enumerate(reqs[:8])]

    def serve_cli(switch, hw, reqs, want, extra, tol_max, tol_mean):
        release_cached_memory()
        port = free_port()
        t0 = time.perf_counter()
        log = open(os.path.join(tmp.name, f"serve_{hw}.log"), "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "sketchedit_tpu_torch.cli.serve",
             *SERVE_FLAGS, "--checkpoints_dir", serve_ck, "--port", str(port),
             "--edit_size", str(hw), "--max_batch", "8", "--device", "cuda",
             *extra], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, switch: "1",
                 "SERVE_WARMUP_WATCHDOG_S": str(SERVER_UP_S)})
        base = f"http://127.0.0.1:{port}"
        try:
            while True:     # the port is bound only after warm-up
                assert proc.poll() is None, "the server exited"
                assert time.perf_counter() - t0 < SERVER_UP_S, "never bound"
                try:
                    if http(base + "/healthz", timeout=5) == (200, b"ok"):
                        break
                except OSError:
                    time.sleep(0.5)
            up_s = time.perf_counter() - t0
            results = [None] * 4

            def post_json(i):
                img, sk = reqs[i]
                status, body = http(base + "/edit", json.dumps({
                    "image": png_b64(img), "sketch": png_b64(sk[:, :, 0])}
                    ).encode(), "application/json")
                assert status == 200, status
                reply = json.loads(body)
                results[i] = tuple(np.asarray(Image.open(io.BytesIO(
                    base64.b64decode(reply[k])))) for k in ("image", "mask"))
            threads = [threading.Thread(target=post_json, args=(i,))
                       for i in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert all(r is not None for r in results)
            status, body = http(base + "/edit", b"".join(
                rawproto.encode(img, sk[:, :, 0]) for img, sk in reqs[:8]),
                "application/octet-stream")
            assert status == 200
            frames = rawproto.decode_frames(body)
            assert len(frames) == 8
            results += [(f[0], f[1][:, :, 0]) for f in frames]
            assert http(base + "/edit", b"SKED\x01", "application/"
                        "octet-stream")[0] == 400
            assert http(base + "/edit", b"{not json",
                        "application/json")[0] == 400
            assert http(base + "/nope", b"{}", "application/json")[0] == 404
            worst, means, each = 0, [], []
            for got, refs in zip(results, [*want[:4], *want[:8]]):
                assert got[0].shape == (hw, hw, 3), got[0].shape
                assert got[1].shape == (hw, hw), got[1].shape
                # the nearer of the two batch sizes' references
                errs_ = [(max(u8_diff(got[0], w_c[0]).max(),
                              u8_diff(got[1], w_m[0, :, :, 0]).max()),
                          u8_diff(got[0], w_c[0]).mean(),
                          int((got[1] != w_m[0, :, :, 0]).sum()))
                         for w_c, w_m in refs]
                err, mean, _ = min(errs_)
                each.append([[int(e), float(m), f] for e, m, f in errs_])
                worst = max(worst, err)
                means.append(mean)
            if worst > tol_max or np.mean(means) > tol_mean:
                free, total = torch.cuda.mem_get_info()
                emit({"phase": "serve_cli_mismatch", "switch": switch,
                      "hw": [hw, hw], "per_result_vs_b1_and_b8": each,
                      "free_bytes": free, "total_bytes": total,
                      "reserved_bytes": torch.cuda.memory_reserved()})
            assert worst <= tol_max and np.mean(means) <= tol_mean, (
                worst, np.mean(means))
            deadline = time.time() + 30      # /stats: poll, as its users do
            while True:
                stats = json.loads(http(base + "/stats")[1])
                # 9 warm-up requests (buckets 1 and 8), 4 JSON, 8 raw frames
                if (stats["executor"]["requests_served"] >= 9 + 4 + 8
                        and stats["raw_path_stages"]["totals"]["bodies"]):
                    break
                assert time.time() < deadline, stats
                time.sleep(0.05)
            assert stats["http"] == {"ok": 5, "client_error": 3,
                                     "server_error": 0}, stats["http"]
            assert stats["executor"]["batch_errors"] == 0
            assert stats["raw_path_stages"]["totals"]["frames"] == 8
            emit({"phase": "serve_cli", "switch": switch, "hw": [hw, hw],
                  "flags": list(extra), "seconds_to_healthz": round(up_s, 1),
                  "json_posts": 4, "raw_frames": 8,
                  "max_u8_diff_vs_in_process": int(worst),
                  "mean_u8_diff_vs_in_process": float(np.mean(means)),
                  "batch_size_histogram":
                      stats["executor"]["batch_size_histogram"],
                  "dispatch_ms": stats["executor"]["dispatch_ms"], **card})
        except BaseException:
            log.seek(0)
            print(log.read()[-4000:], file=sys.stderr)
            raise
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
            log.close()

    refs512 = bucket_references(f32_pipe, reqs512)
    with env(SKETCHEDIT_DSPLIT_ATTN="1"):
        refs512_dsplit = bucket_references(f32_pipe, reqs512)
    # the in-process references through the default and D-split forwards:
    # float32 edits within 1 LSB of each other, at B = 1 and B = 8
    ref_diffs = [[int(u8_diff(a[0][0], b[0][0]).max())
                  for a, b in zip(ra, rb)]
                 for ra, rb in zip(refs512, refs512_dsplit)]
    emit({"phase": "serve_references_dsplit_vs_default", "hw": [512, 512],
          "max_u8_diff": ref_diffs})
    assert max(map(max, ref_diffs)) <= 1, ref_diffs
    serve_cli("SKETCHEDIT_DSPLIT_ATTN", 512, reqs512, refs512, F32,
              tol_max=1, tol_mean=1.0)
    del f32_pipe
    _, pipe = serve_pipeline(ApiOptions)
    bf16_refs = bucket_references(pipe, reqs256)
    del pipe
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # bfloat16: the kernels' summation orders flip roundings, which the bf16
    # convs amplify to a few LSB (3 at worst on an H100 80GB HBM3)
    serve_cli("SKETCHEDIT_SHARED_ATTN", 256, reqs256, bf16_refs, (),
              tol_max=8, tol_mean=1.0)

    # the demo: DemoApp in process on the card, with and without the
    # crop-edit-paste composite, then one round trip over HTTP
    static = os.path.join(tmp.name, "static")
    os.makedirs(os.path.join(static, "images"))
    demo_img, demo_sk = batch(1, 256, 256, args.seed + 600)
    Image.fromarray(demo_img[0]).save(os.path.join(static, "images",
                                                   "example.png"))
    sk_img = Image.fromarray(demo_sk[0, :, :, 0])
    demo_opt, pipe = serve_pipeline(DemoOptions)
    assert not demo_opt.face_crop and demo_opt.compute_dtype == "bfloat16"
    for face_crop in (False, True):
        app = DemoApp(pipe, static_root=static, face_crop=face_crop)
        zero_counts(attention_cuda)
        name = app.process_image(Image.fromarray(demo_img[0]), sk_img,
                                 f"demo_{int(face_crop)}.png",
                                 save_to_input=False)
        assert counts(attention_cuda) == expect(fwd=1)
        out = np.asarray(Image.open(os.path.join(static, "results", name)))
        assert out.shape == (256, 256, 3)
        changed = float((u8_diff(out, demo_img[0]) > 8).mean())
        assert changed > 0.01, "the demo edit changed nothing"
        emit({"phase": "demo_in_process", "face_crop": face_crop,
              "frac_pixels_edited": changed})
    port = free_port()
    threading.Thread(target=demo_serve, args=(app, port), daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 30
    while True:
        try:
            status, page = http(base + "/", timeout=5)
            break
        except OSError:
            assert time.time() < deadline, "the demo server never bound"
            time.sleep(0.1)
    assert status == 200 and b"example.png" in page and b"canvas" in page
    buf = io.BytesIO()
    sk_img.save(buf, format="PNG")
    status, body = http(base + "/", urllib.parse.urlencode({
        "imgname": "example.png", "im_idx": "0",
        "mask": "data:image/png;base64,"
                + base64.b64encode(buf.getvalue()).decode()}).encode())
    assert (status, body) == (200, b"/?idx=0")
    page = http(base + "/?idx=0")[1].decode()
    name = page.split("/static/images/")[1].split('"')[0].split("?")[0]
    assert name.startswith("result_")
    status, body = http(f"{base}/static/images/{name}")
    assert status == 200
    assert Image.open(io.BytesIO(body)).size == (256, 256)
    assert http(base + "/", b"mask=%40%40notbase64")[0] == 400
    emit({"phase": "demo_http", "result": name})
    del pipe, app
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 8b. serving from exported programs (server/artifact.py), the serve CLI
    # on them, netG at the non-released splitcam configurations, and the
    # convergence check ----------------------------------------------------
    import importlib.util
    from sketchedit_tpu_torch.models import editline2 as e2
    from sketchedit_tpu_torch.models.deepfill_c2 import (
        DeepFillC2Generator, DeepFillConfig as NetGConfig)
    from sketchedit_tpu_torch.ops.attention import SplitCAMConfig
    from sketchedit_tpu_torch.server.artifact import (
        ArtifactPipeline, export_edit_artifact, load_edit_artifact)
    art_dir = os.path.join(tmp.name, "artifacts")
    os.makedirs(art_dir)
    # `artifact`: each dtype's live pipeline exported at 256^2, B = 1 and 4;
    # loaded and run in a fresh process; its uint8 outputs held to the live
    # pipeline's on the same inputs, one forward launch per call. Times:
    # the live edit_u8 and the loaded artifact on the same device tensors,
    # in this process, in turns (live, artifact, artifact, live)
    spec, live, live_row = [], {}, {}
    for dt in ("float32", "bfloat16"):
        model = pipes[dt].model
        for B in (1, 4):
            tag = f"{dt}_b{B}"
            path = os.path.join(art_dir, f"{tag}.pt2")
            t0 = time.perf_counter()
            meta = export_edit_artifact(model, path, size=256, batch=B)
            export_s = time.perf_counter() - t0
            assert meta["forward_kernel"] == "default", meta
            img, sk = batch(B, 256, 256, args.seed + 700 + B)
            inputs = os.path.join(art_dir, f"{tag}.npz")
            np.savez(inputs, image=img, sketch=sk)
            spec.append({"tag": tag, "path": path, "inputs": inputs})
            live[tag] = pipes[dt](img, sk)
            it, st = (torch.from_numpy(a).to(dev) for a in (img, sk))
            call = load_edit_artifact(path)
            n0 = counts(attention_cuda)
            with torch.inference_mode():
                turns = [cuda_ms(fn, reps=10) for fn in (
                    lambda: e2.edit_u8(model, it, st), lambda: call(it, st),
                    lambda: call(it, st), lambda: e2.edit_u8(model, it, st))]
            set_counts(attention_cuda, n0)      # timing launches not counted
            live_row[tag] = {"dtype": dt, "batch": B, "bytes": meta["bytes"],
                             "export_s": round(export_s, 2),
                             "live_ms": [turns[0], turns[3]],
                             "artifact_ms": [turns[1], turns[2]]}
            del call
    spec_path = os.path.join(art_dir, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    probe_out = os.path.join(art_dir, "probe.npz")
    release_cached_memory()
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.artifact_probe(*sys.argv[1:])", spec_path, probe_out],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    probe_s = time.perf_counter() - t0
    with open(probe_out + ".json") as f:
        report = json.load(f)
    got = np.load(probe_out)
    assert report["model_modules"] == [], report["model_modules"]
    art_launches = {"float32": 0, "bfloat16": 0}
    for tag, row in live_row.items():
        want_c, want_m = live[tag]
        diff_c = u8_diff(got[tag + ".composite"], want_c)
        diff_m = u8_diff(got[tag + ".mask"], want_m)
        used = report[tag]["launches"]
        art_launches[row["dtype"]] += used["fwd"]
        emit({"phase": "artifact", **row,
              "max_u8_diff_vs_live": int(max(diff_c.max(), diff_m.max())),
              "frac_u8_diff_vs_live": float((diff_c > 0).mean()),
              "launches_per_call": used,
              "precision": report[tag]["meta"]["precision"],
              "probe_process_s": round(probe_s, 1),
              "model_modules_imported": report["model_modules"], **card})
        assert used == expect(fwd=1), (tag, used)
        assert max(diff_c.max(), diff_m.max()) <= 1, tag
    # the same float32 pipeline exported under each forward switch: the
    # switch is read at export and baked into the program
    variant_art_launches = {}
    with np.load(os.path.join(art_dir, "float32_b1.npz")) as z:
        it, st = (torch.from_numpy(z[k]).to(dev) for k in ("image", "sketch"))
    for switch, kernel in (("SKETCHEDIT_SHARED_ATTN", "shared"),
                           ("SKETCHEDIT_DSPLIT_ATTN", "dsplit")):
        path = os.path.join(art_dir, f"float32_b1_{kernel}.pt2")
        with env(**{switch: "1"}):
            meta = export_edit_artifact(pipes["float32"].model, path,
                                        size=256, batch=1)
        assert meta["forward_kernel"] == kernel, meta
        call = load_edit_artifact(path)
        with torch.inference_mode():
            zero_counts(attention_cuda)
            composed, mask = call(it, st)
            torch.cuda.synchronize()
            used = counts(attention_cuda)
            ms = cuda_ms(lambda: call(it, st), reps=10)
        variant_art_launches[kernel] = used[kernel]
        diff = max(u8_diff(composed.cpu().numpy(), live["float32_b1"][0]).max(),
                   u8_diff(mask.cpu().numpy(), live["float32_b1"][1]).max())
        emit({"phase": "artifact", "forward_kernel": kernel, "dtype":
              "float32", "batch": 1, "launches_per_call": used,
              "max_u8_diff_vs_live_default": int(diff), "artifact_ms": ms,
              **card})
        assert used == expect(**{kernel: 1}), (kernel, used)
        assert diff <= 1, kernel
        del call

    # `serve_artifact`: the serve CLI on the float32 B = 1 and B = 4
    # artifacts alone, 8 JSON posts from 4 clients. A row is held within 1
    # LSB of the artifact of its bucket run on its input (the executor pads
    # 2..4 requests to 4; rows are independent in every op) and its
    # distance to the B = 1 artifact is reported: netM's soft mask may
    # cross 0.5 between batch sizes (ROADMAP.md's known differences)
    f32_paths = [os.path.join(art_dir, f"float32_b{B}.pt2") for B in (1, 4)]
    reqs = [tuple(a[0] for a in batch(1, 256, 256, args.seed + 800 + i))
            for i in range(8)]
    ref_pipe = ArtifactPipeline(f32_paths)
    zero_counts(attention_cuda)
    refs = [(ref_pipe(img[None], sk[None]),
             ref_pipe(np.repeat(img[None], 4, 0), np.repeat(sk[None], 4, 0)))
            for img, sk in reqs]
    torch.cuda.synchronize()
    assert counts(attention_cuda) == expect(fwd=16)
    art_launches["float32"] += 16
    del ref_pipe
    release_cached_memory()
    port = free_port()
    t0 = time.perf_counter()
    log = open(os.path.join(tmp.name, "serve_artifact.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sketchedit_tpu_torch.cli.serve", "--name",
         "x", "--checkpoints_dir", os.path.join(tmp.name, "no_ck"),
         "--port", str(port), "--device", "cuda",
         *(a for p_ in f32_paths for a in ("--serve_artifact", p_))],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "SERVE_WARMUP_WATCHDOG_S": str(SERVER_UP_S)})
    base = f"http://127.0.0.1:{port}"
    try:
        while True:     # the port is bound only after warm-up
            assert proc.poll() is None, "the server exited"
            assert time.perf_counter() - t0 < SERVER_UP_S, "never bound"
            try:
                if http(base + "/healthz", timeout=5) == (200, b"ok"):
                    break
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        replies = [None] * 8

        def client(c):
            for i in (c, c + 4):
                img, sk = reqs[i]
                status, body = http(base + "/edit", json.dumps({
                    "image": png_b64(img), "sketch": png_b64(sk[:, :, 0])}
                    ).encode(), "application/json")
                assert status == 200, status
                reply = json.loads(body)
                replies[i] = tuple(np.asarray(Image.open(io.BytesIO(
                    base64.b64decode(reply[k])))) for k in ("image", "mask"))
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        assert all(r is not None for r in replies)
        assert http(base + "/edit", b"{not json",
                    "application/json")[0] == 400
        assert http(base + "/nope", b"{}", "application/json")[0] == 404
        vs_b1, vs_bucket = [], []
        for (c, m), (b1, b4) in zip(replies, refs):
            d = [max(u8_diff(c, ref[0][0]).max(),
                     u8_diff(m, ref[1][0, :, :, 0]).max())
                 for ref in (b1, b4)]
            vs_b1.append(int(d[0]))
            vs_bucket.append(int(min(d)))
        deadline = time.time() + 30      # /stats: poll, as its users do
        while True:
            stats = json.loads(http(base + "/stats")[1])
            # 5 warm-up requests (buckets 1 and 4), 8 JSON posts
            if stats["executor"]["requests_served"] >= 5 + 8:
                break
            assert time.time() < deadline, stats
            time.sleep(0.05)
        emit({"phase": "serve_artifact", "artifacts": ["b1", "b4"],
              "seconds_to_healthz": round(up_s, 1), "json_posts": 8,
              "clients": 4, "max_u8_diff_vs_b1_artifact": vs_b1,
              "max_u8_diff_vs_bucket_artifact": vs_bucket,
              "http": stats["http"], "edit_size": stats["edit_size"],
              "max_batch": stats["max_batch"],
              "batch_size_histogram":
                  stats["executor"]["batch_size_histogram"],
              "dispatch_ms": stats["executor"]["dispatch_ms"], **card})
        assert max(vs_bucket) <= 1, vs_bucket
        assert stats["http"] == {"ok": 8, "client_error": 2,
                                 "server_error": 0}, stats["http"]
        assert (stats["edit_size"], stats["max_batch"]) == (256, 4)
        assert stats["executor"]["batch_errors"] == 0
    except BaseException:
        log.seek(0)
        print(log.read()[-4000:], file=sys.stderr)
        raise
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=60)
        log.close()

    # `splitcam_variants`: netG at 256^2, B = 1, float32 with TF32 off, at
    # every reference configuration: on the card against the same call on
    # the CPU. The released one takes the forward kernel (one launch), as
    # the JAX netG takes its Pallas call; the other seven run splitcam as
    # dense torch, with no attention kernel launch
    g_state = {k: v.cpu() for k, v in
               pipes["float32"].model.netG.state_dict().items()}
    r_ = np.random.RandomState(args.seed + 900)
    xs = torch.from_numpy(r_.uniform(-1, 1, (1, 3, 256, 256)).astype(
        np.float32))
    ms_ = hole_mask(1, 256, 256)
    gs = torch.from_numpy((r_.rand(1, 1, 256, 256) > 0.95).astype(
        np.float32))
    released_out = None
    for name, ov in SPLITCAM_VARIANTS.items():
        cfg = NetGConfig(attention=SplitCAMConfig(**ov))
        outs = {}
        for d in ("cuda", "cpu"):
            net = DeepFillC2Generator(cfg, device=d)
            net.load_state_dict(g_state)
            net.eval()
            x_, m_, g_ = (t.to(d) for t in (xs, ms_, gs))
            with torch.inference_mode():
                if d == "cuda":
                    zero_counts(attention_cuda)
                outs[d] = net(x_, x_, m_, m_, g_)[1].float().cpu()
                if d == "cuda":
                    torch.cuda.synchronize()
                    used = counts(attention_cuda)
                    ms = cuda_ms(lambda: net(x_, x_, m_, m_, g_), reps=5)
        err = (outs["cuda"] - outs["cpu"]).abs().max().item()
        released_out = outs["cpu"] if name == "released" else released_out
        emit({"phase": "splitcam_variants", "variant": name,
              "config": ov, "hw": [256, 256], "batch": 1, "dtype": "float32",
              "max_abs_diff_gpu_vs_cpu": err, "tol": SPLITCAM_TOL,
              "max_abs_diff_vs_released": (
                  outs["cpu"] - released_out).abs().max().item(),
              "ms_per_call": ms, "attention_launches": used, **card})
        assert torch.isfinite(outs["cuda"]).all(), name
        assert used == (expect(fwd=1) if name == "released"
                        else expect()), (name, used)
        assert err <= SPLITCAM_TOL, (name, err)
        del net

    # `convergence`: scripts/convergence_check_torch.py, bfloat16 on the
    # kernel route at its defaults (128^2, B = 8, lr 1e-3, the 0.7 gate on
    # the last step's L1c and L1f) but 900 steps, which must end CONVERGES.
    # At the default 450 steps the gate is a coin flip on an H100 80GB HBM3
    # (700 W) for the kernel and the dense route alike: three flag seeds of
    # six pass on each, the default seed fails on the kernel route at an L1f
    # ratio of 0.73 (PERF.md §6). Each step launches the forward
    # twice (the lse for the G step), dQ and dK/dV once.
    conv_spec = importlib.util.spec_from_file_location(
        "convergence_check_torch",
        os.path.join(ROOT, "scripts", "convergence_check_torch.py"))
    conv = importlib.util.module_from_spec(conv_spec)
    conv_spec.loader.exec_module(conv)
    buf = io.StringIO()
    zero_counts(attention_cuda)
    with contextlib.redirect_stdout(buf):
        rc = conv.main(["--steps", "900"])
    conv_launches = counts(attention_cuda)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conv_lines = buf.getvalue().strip().splitlines()
    result = json.loads(conv_lines[-1])
    # the L1 ratios at step 450 of the printout (the default run's length)
    logged = {int(ln.split(" ", 1)[0]): ast.literal_eval(ln.split(" ", 1)[1])
              for ln in conv_lines if ln.split(" ", 1)[0].isdigit()}
    emit({"phase": "convergence", "exit_code": rc,
          "printout": conv_lines[:-1], **result,
          "ratios_at_step_450": {k: logged[450][k] / logged[0][k]
                                 for k in ("L1c", "L1f")},
          "launches_counted": conv_launches})
    steps = result["steps"]
    assert rc == 0 and result["converges"], conv_lines[-2]
    assert conv_launches == expect(fwd=2 * steps, fwd_lse=steps,
                                   bwd=steps), conv_launches

    # 8c. `packing`: the space-to-depth packed fronts and tails
    # (ops/packed_tail.py) against the plain layers, the route forced with
    # SKETCHEDIT_PACK / SKETCHEDIT_PACK_MID (read on every call) or the
    # nets' ``pack``. The same math: each packed group held to its plain
    # layers on the same input (PACK_GROUP_TOL), each route's nets to
    # float64 (PACK_F64_RATIO), float32 composites within 1 LSB. Then the
    # ABBA times that set use_packing's crossover.
    pack_launches = {"float32": expect(), "bfloat16": expect()}

    def add_launches(dt, used):
        for k, v in used.items():
            pack_launches[dt][k] += v

    def net_outputs(nets, dtype, it, st, hard, pack):
        """netM's (soft mask, image) and netG's (coarse, fine) on the same
        inputs, netG on the given hard mask, as float64."""
        x = it.permute(0, 3, 1, 2).to(dtype) / 127.5 - 1.0
        s_ = (st.permute(0, 3, 1, 2) > 0).to(dtype)
        hd = hard.to(dtype)
        outs = [*nets[0](x, s_, pack=pack),
                *nets[1](x, x, hd, hd, s_, pack=pack)]
        return [o.double() for o in outs]

    def pack_vs_plain(dt, B, H, seed, mid=False):
        """One packed and one plain edit_u8; each packed group against its
        plain layers on the inputs of the plain nets' run; the nets on the
        edit's inputs held to a float64 evaluation of the same weights
        (netG on the dense attention): the row of differences, checked,
        with the launches counted."""
        model = pipes[dt].model
        ref_g = DeepFillC2Generator(dataclasses.replace(
            model.netG.config, attention_impl="dense"), device=dev,
            dtype=torch.float64)
        ref_g.load_state_dict(model.netG.state_dict())
        ref_m = type(model.netM)(device=dev, dtype=torch.float64)
        ref_m.load_state_dict(model.netM.state_dict())
        img, sk = batch(B, H, H, seed)
        it, st = (torch.from_numpy(a).to(dev) for a in (img, sk))
        with torch.inference_mode(), env(SKETCHEDIT_PACK_MID=str(int(mid))):
            zero_counts(attention_cuda)
            with env(SKETCHEDIT_PACK="1"):
                got = e2.edit_u8(model, it, st)
            torch.cuda.synchronize()
            used = counts(attention_cuda)
            with env(SKETCHEDIT_PACK="0"):
                want = e2.edit_u8(model, it, st)
                hard = e2.generate(
                    model, it.permute(0, 3, 1, 2) / 127.5 - 1.0,
                    (st.permute(0, 3, 1, 2) > 0).float())["mask_inpaint"]
            nets = (model.netM, model.netG)
            outs = [net_outputs(nets, model.config.dtype, it, st, hard, p)
                    for p in (True, False)]
            ref = net_outputs((ref_m, ref_g), torch.float64, it, st, hard,
                              False)
            groups = packed_group_errors(
                {"M": model.netM, "G": model.netG},
                lambda: net_outputs(nets, model.config.dtype, it, st, hard,
                                    False))
        assert used == expect(fwd=1), used
        add_launches(dt, used)
        d_c = u8_diff(got[0].cpu().numpy(), want[0].cpu().numpy())
        d_m = u8_diff(got[1].cpu().numpy(), want[1].cpu().numpy())
        # per output: max |packed - plain|, and each route's L2 distance
        # from float64 over the float64 output's L2 norm
        diff = [(a - b).abs().max().item() for a, b in zip(*outs)]
        dist = {route: [((o - r).norm() / r.norm()).item()
                        for o, r in zip(o_, ref)]
                for route, o_ in zip(("packed", "plain"), outs)}
        row = {"phase": "packing", "check": "nets", "dtype": dt, "batch": B,
               "hw": [H, H], "mid": mid, "launches": used,
               "outputs": ["netM_mask", "netM_image", "netG_coarse",
                           "netG_fine"],
               "max_abs_diff_packed_vs_plain": diff,
               "max_u8_steps_packed_vs_plain": [
                   d * (255.0 if i == 0 else 127.5)
                   for i, d in enumerate(diff)],
               "group_rel_err": groups,
               "group_tol": PACK_GROUP_TOL[dt],
               "rel_l2_vs_float64": dist, "f64_ratio": PACK_F64_RATIO,
               "f64_floor": PACK_F64_FLOOR,
               "max_u8_diff_composite": int(d_c.max()),
               "max_u8_diff_mask": int(d_m.max()),
               "frac_u8_diff_composite": float((d_c > 0).mean())}
        emit(row)
        assert all(np.isfinite(diff)), row
        assert all(e <= PACK_GROUP_TOL[dt] for e in groups.values()), row
        for p_, q_ in zip(dist["packed"], dist["plain"]):
            assert p_ <= max(PACK_F64_RATIO * q_, PACK_F64_FLOOR), row
        if dt == "float32":
            assert d_m.max() <= 1 and d_c.max() <= 1, row
        del ref_g, ref_m

    t_pack = time.perf_counter()
    for dt in ("float32", "bfloat16"):
        set_precision("highest" if dt == "float32" else None)
        for B in (1, 4):
            pack_vs_plain(dt, B, 256, args.seed + 1300 + B)
        pack_vs_plain(dt, 1, 256, args.seed + 1310, mid=True)
    set_precision("highest")
    # 252^2: the edit pads it to 256^2; the nets called at 252^2 run their
    # packed layers on 126^2 grids (and the attention at 63^2)
    pack_vs_plain("float32", 1, 252, args.seed + 1320)

    # one G+D step at 256^2, B = 8, float32 (TF32 off), packed against
    # plain, from the train state's own initialisation (as a training run
    # starts): the losses as train_step_kernel_vs_dense holds them, every
    # gradient within GRAD_TOL, the exact launch counts. (From the scaled
    # weights of the other checks, netM's float32 forward lies several
    # hundred roundings from float64 (4.4e-5 on its image), its L1 losses
    # change sign on the pixels that moves, and its gradients differ by
    # 1.2-1.5e-2 between the routes under any cuDNN setting, deterministic
    # or off included: scripts/packing_grad_numerics_torch.py.)
    steps_pm = {}
    for route, flag in PACK_ROUTES:
        with env(SKETCHEDIT_PACK=flag):
            steps_pm[route] = one_step("float32", "kernel", batch8, (1, 1),
                                       scaled=False)
        assert steps_pm[route][2] == expect(fwd=2, fwd_lse=1,
                                            bwd=1), steps_pm[route][2]
        add_launches("float32", steps_pm[route][2])
    row = {"phase": "packing", "check": "train_step", "hw": [256, 256],
           "batch": 8, "dtype": "float32", "flag": 1,
           "weights": "init_train_state",
           "max_loss_rel_diff": losses_agree(steps_pm["packed"][0],
                                             steps_pm["plain"][0]),
           "grad_err": grad_errors(steps_pm["packed"][1],
                                   steps_pm["plain"][1]),
           "grad_tol": GRAD_TOL, "launches": steps_pm["packed"][2]}
    emit(row)
    del steps_pm

    # a float32 artifact exported packed, run in a fresh process, against
    # the live packed edit
    path = os.path.join(art_dir, "float32_b1_packed.pt2")
    with env(SKETCHEDIT_PACK="1"):
        meta = export_edit_artifact(pipes["float32"].model, path, size=256,
                                    batch=1)
    assert meta["pack"] is True, meta
    img, sk = batch(1, 256, 256, args.seed + 1330)
    inputs = os.path.join(art_dir, "packed.npz")
    np.savez(inputs, image=img, sketch=sk)
    with open(spec_path, "w") as f:
        json.dump([{"tag": "packed", "path": path, "inputs": inputs}], f)
    r = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "chip_smoke.artifact_probe(*sys.argv[1:])", spec_path, probe_out],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    with open(probe_out + ".json") as f:
        report = json.load(f)
    got = np.load(probe_out)
    it, st = (torch.from_numpy(a).to(dev) for a in (img, sk))
    with torch.inference_mode(), env(SKETCHEDIT_PACK="1"):
        live_c, live_m = (t.cpu().numpy()
                          for t in e2.edit_u8(pipes["float32"].model, it, st))
    used = report["packed"]["launches"]
    diff = max(u8_diff(got["packed.composite"], live_c).max(),
               u8_diff(got["packed.mask"], live_m).max())
    emit({"phase": "packing", "check": "artifact", "dtype": "float32",
          "batch": 1, "hw": [256, 256], "pack": report["packed"]["meta"][
              "pack"], "bytes": meta["bytes"], "launches_per_call": used,
          "max_u8_diff_vs_live_packed": int(diff),
          "model_modules_imported": report["model_modules"], **card})
    assert report["packed"]["meta"]["pack"] is True
    assert report["model_modules"] == [], report["model_modules"]
    assert used == expect(fwd=1), used
    assert diff <= 1, diff
    add_launches("float32", used)
    check_s = time.perf_counter() - t_pack

    # the ABBA times: the edit per dtype and batch, the train step per mode
    # (the timing calls' launches are not counted)
    saved = counts(attention_cuda)
    for dt in ("float32", "bfloat16"):
        set_precision("highest" if dt == "float32" else None)
        for B in PACK_AB_BATCHES:
            rows = edit_ab(pipes[dt].model, B, args.seed + 1400 + B,
                           top=(dt, B) == ("float32", 8))
            for route, row in rows.items():
                emit({"phase": "packing", "check": "ab", "path": "edit",
                      "dtype": dt, "batch": B, "hw": [256, 256],
                      "route": route, **row, **card})
    for dt, precision in (("bfloat16", "highest"), ("float32", None),
                          ("float32", "highest")):
        state, cfg = train_state(dt, "auto", precision=precision)
        set_precision(precision)
        for route, ms in train_ab(state, cfg, tr.batch_to_device(
                batch8, dev)).items():
            emit({"phase": "packing", "check": "ab", "path": "train_step",
                  "dtype": dt, "tf32": precision is None, "batch": 8,
                  "hw": [256, 256], "route": route, "ms": ms, **card})
        del state
    set_precision("highest")
    set_counts(attention_cuda, saved)
    emit({"phase": "packing", "check": "done", "launches": pack_launches,
          "check_seconds": round(check_s, 1),
          "seconds": round(time.perf_counter() - t_pack, 1)})

    # 9. times ------------------------------------------------------------
    for B in (1, 4):
        img, sk = batch(B, 256, 256, args.seed + 50 + B)
        row = {"phase": "time_main_path", "hw": [256, 256], "batch": B,
               "dtype": "float32", **card}
        for impl, p in (("kernel", pipes["float32"]),
                        ("dense", dense["float32"])):
            row[f"{impl}_ms_per_image"] = cuda_ms(lambda: p(img, sk),
                                                  reps=10) / B
        emit(row)
    img, sk = batch(4, 256, 256, args.seed + 60)
    emit({"phase": "time_main_path", "hw": [256, 256], "batch": 4,
          "dtype": "bfloat16", **card,
          "kernel_ms_per_image": cuda_ms(lambda: pipes["bfloat16"](img, sk),
                                         reps=10) / 4,
          "dense_ms_per_image": cuda_ms(lambda: dense["bfloat16"](img, sk),
                                        reps=10) / 4})

    # train step: 256^2, B = 8, flags (1, 1), through the kernels
    saved = counts(attention_cuda)
    tb = tr.batch_to_device(batch8, dev)
    step_img_per_s = {}
    for dt, tf32 in (("float32", False), ("float32", True),
                     ("bfloat16", False)):
        state, cfg = train_state(dt, "auto")
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        ms = cuda_ms(lambda: tr.train_step(state, tb, 1, 1, cfg), reps=3,
                     warmup=1)
        step_img_per_s[dt] = 8000.0 / ms
        emit({"phase": "time_train_step", "hw": [256, 256], "batch": 8,
              "dtype": dt, "tf32": tf32, "ms_per_step": ms,
              "img_per_s": 8000.0 / ms, **card})
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    del state

    # the editimage loader at 256^2, B = 8, per --nThreads, beside the
    # bfloat16 step: does it hold the step back in steady state? 400 seeded
    # photo-like PNGs at 512^2, resized to 256^2 as a dataset of larger
    # photos is, so an epoch is 50 batches. Per path, uncached (every item
    # decoded, as on a dataset larger than the decode cache) and with the
    # default 512 MB cache: two epochs alone (the first starts the pool and
    # fills the cache), then one feeding the bfloat16 train loop. The steady
    # rate leaves out each epoch's first `skip` batches; `fill_s` is the
    # wait for the first batch of an epoch. The control is the loop over
    # the same 50 batches held in memory.
    photos = os.path.join(tmp.name, "photos")
    os.makedirs(photos)
    r = np.random.RandomState(args.seed + 700)
    arrays = [photo_like(r, 512) for _ in range(400)]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda i: Image.fromarray(arrays[i]).save(
            os.path.join(photos, f"{i:04d}.png")), range(len(arrays))))
    del arrays
    pns = argparse.Namespace(**{**vars(ns), "train_image_dir": photos})
    skip = 10

    def rates(stamps, start, end):
        n = len(stamps)
        return {"steady_img_per_s": 8 * (n - skip) / (end - stamps[skip - 1]),
                "epoch_img_per_s": 8 * n / (end - start),
                "fill_s": stamps[0] - start}

    def alone(loader):
        stamps, start, cpu0 = [], time.perf_counter(), time.process_time()
        for _ in loader:
            stamps.append(time.perf_counter())
        return {**rates(stamps, start, stamps[-1]),
                "main_cpu_s": time.process_time() - cpu0}

    def fed(batches):
        # a step's stamp is taken once it is dispatched; the end waits for
        # the device, so the steady window also counts the steps in flight
        stamps = []
        torch.cuda.synchronize()
        start = time.perf_counter()
        train_loop(state, batches, cfg,
                   on_step=lambda m: stamps.append(time.perf_counter()))
        torch.cuda.synchronize()
        return rates(stamps, start, time.perf_counter())

    def proc_stats(pid):
        # resident memory, CPU seconds, and whether torch or a CUDA device
        # file is mapped there
        with open(f"/proc/{pid}/status") as f:
            rss_kb = int(f.read().split("VmRSS:")[1].split()[0])
        with open(f"/proc/{pid}/stat") as f:
            ticks = f.read().rsplit(")", 1)[1].split()
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
        return {"rss_mb": rss_kb / 1024,
                "cpu_s": (int(ticks[11]) + int(ticks[12]))
                / os.sysconf("SC_CLK_TCK"),
                "maps_libtorch": "libtorch" in maps,
                "maps_dev_nvidia": "/dev/nvidia" in maps}

    def workers(loader):
        # the spawned workers; spawn imports the parent's main module again
        return [proc_stats(pid) for pid in loader._pool._processes]

    host = {"cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0))}

    state, cfg = train_state("bfloat16", "auto")
    with contextlib.redirect_stdout(io.StringIO()):
        held = list(data_mod.create_dataloader(
            argparse.Namespace(**{**vars(pns), "decode_cache_mb": 0})))
    assert len(held) == 50
    train_loop(state, held[:3], cfg)
    held_rates = fed(held)
    emit({"phase": "loader_rate_held", "hw": [256, 256], "batch": 8,
          "batches": len(held), **held_rates, "skip": skip,
          "bf16_step_img_per_s": step_img_per_s["bfloat16"], "host": host,
          **card})
    del held
    for cache_mb in (0, 512):
        for n_threads in (0, 1, 2, 4):
            lns = argparse.Namespace(**{**vars(pns), "nThreads": n_threads,
                                        "decode_cache_mb": cache_mb})
            with contextlib.redirect_stdout(io.StringIO()):
                loader = data_mod.create_dataloader(lns)
            try:
                first = alone(loader)
                second = alone(loader)
                loop = fed(loader)
                extra = ({"workers": workers(loader)}
                         if loader.mode == "processes" else {})
            finally:
                loader.close()
            emit({"phase": "loader_rate", "hw": [256, 256],
                  "source_hw": [512, 512], "batch": 8,
                  "batches_per_epoch": len(loader), "skip": skip,
                  "nThreads": n_threads, "mode": loader.mode,
                  "decode_cache_mb": cache_mb, "alone_epoch1": first,
                  "alone_epoch2": second, "loop": loop,
                  "loop_x_held": loop["steady_img_per_s"]
                  / held_rates["steady_img_per_s"], **extra,
                  "bf16_step_img_per_s": step_img_per_s["bfloat16"],
                  **card})
    del state

    # the backward kernels at the training path's shapes (256^2, B = 1 and
    # 8); the library call is the backward of SDPA on the same function,
    # through autograd from a retained graph
    bwd_times = {}
    for (B, dt), bargs in bwd_inputs.items():
        Q, K, V, keep, lse, delta, dO, _, ksc = bargs
        assert Q is K and K is V
        N, D = Q.shape[1:]
        P = K.shape[1]
        row = {"phase": "time_bwd_kernel", "shape_BNPD": [B, N, P, D],
               "dtype": str(dt).split(".")[-1], **card}
        row["dq_ms"] = cuda_ms(lambda: attention_core_dq(*bargs), reps=10)
        row["dkdv_ms"] = cuda_ms(lambda: attention_core_dkdv(*bargs), reps=10)
        row["bwd_ms"] = cuda_ms(lambda: attention_core_bwd_joint(*bargs),
                                reps=10)
        row["dv_ms"] = cuda_ms(lambda: attention_core_dv(
            Q, K, keep, lse, dO, 10.0, ksc), reps=10)
        row["dk_ms"] = cuda_ms(lambda: attention_core_dk(*bargs), reps=10)
        row["dq_plain_ms"] = cuda_ms(
            lambda: attention_core_dq_reference(*bargs), reps=10)
        row["dkdv_plain_ms"] = cuda_ms(
            lambda: attention_core_dkdv_reference(*bargs), reps=10)
        row["bwd_plain_ms"] = cuda_ms(
            lambda: attention_core_bwd_joint_reference(*bargs), reps=10)
        row["dv_plain_ms"] = cuda_ms(lambda: attention_core_dv_reference(
            Q, K, keep, lse, dO, 10.0, ksc), reps=10)
        row["dk_plain_ms"] = cuda_ms(
            lambda: attention_core_dk_reference(*bargs), reps=10)
        Kg = (V.float() * ksc[:, None, :] * (10.0 * keep)[..., None]).to(dt)
        q_, k_, v_ = (t.detach().clone().requires_grad_() for t in (Q, Kg, V))
        o_ = F.scaled_dot_product_attention(q_, k_, v_, scale=1.0)
        g_ = dO.to(o_.dtype)
        row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            o_, (q_, k_, v_), g_, retain_graph=True), reps=10)
        del o_
        # the work this run's data needs: S and dP over every key, dV over
        # every key (P > 0 for a gated key too), dS-products over the kept
        # keys only; the dK kernel alone needs S, dP and dS^T Q for the kept
        # keys only (a gated key's dS is 0), the dV kernel S and P^T dO for
        # every key, so the split pair counts S twice; the joint backward
        # S, dP and dV over every key, dQ and dK over the kept ones; each
        # input read once (Q, K and V are one tensor), each output written
        # once
        kept = keep.sum().item()
        nprod = 2.0 * B * N * P * D
        flops = {"dq": 2 * nprod + 2.0 * N * D * kept,
                 "dkdv": 3 * nprod + 2.0 * N * D * kept,
                 "bwd": 3 * nprod + 4.0 * N * D * kept,
                 "dv": 2 * nprod, "dk": 6.0 * N * D * kept}
        inputs = B * (Q.element_size() * P * D + 4 * (P + D + N * D + 2 * N))
        nbytes = {"dq": inputs + 4 * B * N * D, "dkdv": inputs + 8 * B * P * D,
                  "bwd": inputs + 4 * B * N * D + 8 * B * P * D,
                  "dv": inputs - 4 * B * N + 4 * B * P * D,
                  "dk": inputs + 4 * B * P * D}
        for k in ("dq", "dkdv", "bwd", "dv", "dk"):
            t_ops = ops_ms(flops[k], str(dt).split(".")[-1], peaks)
            t_bytes = nbytes[k] / peaks["bytes"] * 1e3
            row[f"{k}_bound_ms"] = max(t_ops, t_bytes)
            row[f"{k}_bound_by"] = "bytes" if t_bytes > t_ops else "operations"
            row[f"{k}_gflop"] = flops[k] / 1e9
        # each kernel's loss to the library call and multiple of the bound;
        # dK/dV against the split dV + dK, and the split pair against it;
        # each route's sum of sequences (the joint; dQ + dK/dV; dQ + dV +
        # dK) against the library call, which gives all three gradients,
        # and the joint against dQ + dK/dV
        for k in ("dq", "dkdv", "bwd", "dv", "dk"):
            row[f"{k}_x_library"] = row[f"{k}_ms"] / row["library_ms"]
            row[f"{k}_x_bound"] = row[f"{k}_ms"] / row[f"{k}_bound_ms"]
        row["dq_dkdv_ms"] = row["dq_ms"] + row["dkdv_ms"]
        row["dq_dv_dk_ms"] = row["dq_ms"] + row["dv_ms"] + row["dk_ms"]
        row["dq_dkdv_x_library"] = row["dq_dkdv_ms"] / row["library_ms"]
        row["dq_dv_dk_x_library"] = row["dq_dv_dk_ms"] / row["library_ms"]
        row["bwd_x_dq_dkdv"] = row["bwd_ms"] / row["dq_dkdv_ms"]
        row["dkdv_x_split"] = row["dkdv_ms"] / (row["dv_ms"] + row["dk_ms"])
        row["split_x_fused"] = (row["dv_ms"] + row["dk_ms"]) / row["dkdv_ms"]
        bwd_times[(B, dt)] = row
        emit(row)

    # the three forwards side by side: 256^2 (B = 1 and 8), 512^2 and
    # 1024^2 (B = 1), float32 and bfloat16, float32 output as on the main
    # path; the plain version (not at 1024^2) and the library call beside
    fwd_times = {}
    f1024 = features(rs, 1, 256, 256).to(dev)
    m1024 = hole_mask(1, 256, 256).to(dev)
    for dt in (torch.float32, torch.bfloat16):
        fd = f1024.to(dt)
        variant_inputs[(1, 256, dt)] = attention_inputs(fd, fd, m1024)
    del f1024, fd
    for (B, hw, dt), (Q, V, keep, ksc) in variant_inputs.items():
        N, D = Q.shape[1:]
        reps = 10 if hw < 128 else (5 if hw == 128 else 2)
        f32 = torch.float32
        # how the default (and shared) forward runs this shape: query rows
        # per block, column slabs, blocks resident per SM, shared memory,
        # against the grid's blocks
        plan = fwd_plan(B, N, N, D, dt)
        assert plan == fwd_plan(B, N, N, D, dt, shared=True), plan
        emit({"phase": "fwd_plan", "image_hw": [4 * hw, 4 * hw],
              "shape_BNPD": [B, N, N, D], "dtype": str(dt).split(".")[-1],
              **plan, "ptxas": [p for p in ptxas["fwd_ptxas"] if (
                  ("ELb1ELi" in p["entry"]) == (dt == torch.float32))],
              **card})
        row = {"phase": "time_forwards", "image_hw": [4 * hw, 4 * hw],
               "shape_BNPD": [B, N, N, D], "dtype": str(dt).split(".")[-1],
               **card}
        row["fwd_ms"] = cuda_ms(lambda: attention_core(
            Q, V, V, keep, out_dtype=f32, kscale=ksc), reps, warmup=1)
        row["shared_ms"] = cuda_ms(lambda: attention_core_shared(
            V, ksc, keep, out_dtype=f32), reps, warmup=1)
        row["dsplit_ms"] = cuda_ms(lambda: attention_core_dsplit(
            Q, V, V, keep, out_dtype=f32, kscale=ksc), reps, warmup=1)
        if hw < 256:
            row["plain_ms"] = cuda_ms(lambda: attention_core_reference(
                Q, V, V, keep, out_dtype=f32, kscale=ksc), reps, warmup=1)
            row["dsplit_plain_ms"] = cuda_ms(
                lambda: attention_core_dsplit_reference(
                    Q, V, V, keep, out_dtype=f32, kscale=ksc), reps, warmup=1)
        Ks = (V.float() * ksc[:, None, :] * (10.0 * keep)[..., None]).to(dt)
        row["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            Q, Ks, V, scale=1.0), reps, warmup=1)
        del Ks
        # The three compute one function, so they share one bound: S and
        # P V once each, each input read once (one tensor), the float32
        # output written. The D-split's second S is its design's cost, not
        # work the function needs.
        nbytes = B * (Q.element_size() * N * D + 4 * (N * D + N + D))
        t_bytes = nbytes / peaks["bytes"] * 1e3
        t_ops = ops_ms(4.0 * B * N * N * D, row["dtype"], peaks)
        for k in ("fwd", "shared", "dsplit"):
            row[f"{k}_bound_ms"] = max(t_ops, t_bytes)
            row[f"{k}_bound_by"] = "bytes" if t_bytes > t_ops else "operations"
        # the D-split's loss to the library call, its multiple of the
        # bound, and its time against the default forward's
        row["dsplit_x_library"] = row["dsplit_ms"] / row["library_ms"]
        row["dsplit_x_bound"] = row["dsplit_ms"] / row["dsplit_bound_ms"]
        row["dsplit_x_fwd"] = row["dsplit_ms"] / row["fwd_ms"]
        fwd_times[(B, hw, dt)] = row
        emit(row)
        if B == 1 and hw in (64, 128):
            # the default and D-split forwards against the same function
            # in float64 on the same (bf16-rounded) inputs: both run split
            # TF32, so the D-split, whose two halves contract apart, must
            # be as close as the default kernel over the whole output
            # (relative L2 within 1.5x); the largest |difference|, one
            # element's rounding, is reported beside it
            Vd = V.double()
            logits = torch.bmm(Q.double(), (Vd * ksc.double()[:, None, :])
                               .transpose(1, 2))
            logits = logits * keep.double()[:, None, :] * 10.0
            exact = torch.bmm(torch.softmax(logits, -1), Vd)
            del logits, Vd
            dist = {}
            for k, fn in (("fwd", attention_core),
                          ("dsplit", attention_core_dsplit)):
                got = fn(Q, V, V, keep, out_dtype=f32, kscale=ksc).double()
                dist[f"{k}_max_abs_vs_float64"] = (
                    got - exact).abs().max().item()
                dist[f"{k}_rel_l2_vs_float64"] = (
                    (got - exact).norm() / exact.norm()).item()
                del got
            for m in ("max_abs", "rel_l2"):
                dist[f"dsplit_x_fwd_{m}"] = (dist[f"dsplit_{m}_vs_float64"]
                                             / dist[f"fwd_{m}_vs_float64"])
                dist[f"fwd_x_dsplit_{m}"] = 1.0 / dist[f"dsplit_x_fwd_{m}"]
            emit({"phase": "fwd_vs_float64", "image_hw": [4 * hw, 4 * hw],
                  "shape_BNPD": [B, N, N, D], "dtype": row["dtype"], **dist,
                  **card})
            assert dist["dsplit_x_fwd_rel_l2"] <= 1.5, dist
            assert dist["fwd_x_dsplit_rel_l2"] <= 1.5, dist
            del exact
    set_counts(attention_cuda, saved)        # timing launches do not count

    # served throughput in process at 256^2 with the serve defaults
    # (bfloat16, TF32 allowed): each client sends 8 requests one after
    # another. --max_batch 32 and 128 are read at the same client counts
    # (32 and 128), twice each, in turn; with 32 clients a limit of 128
    # never fills, so each batch waits out the executor's 20 ms window.
    _, pipe = serve_pipeline(ApiOptions)
    for clients, max_batch in ((32, 1), (32, 8), (32, 32), (32, 128),
                               (128, 32), (128, 128), (32, 32), (32, 128),
                               (128, 32), (128, 128)):
        reqs = [reqs256[i % 32] for i in range(clients * 8)]
        _, stats, _, seconds, latency = served(pipe, reqs, max_batch, clients)
        lat = np.sort(np.asarray(latency))
        emit({"phase": "time_serving", "hw": [256, 256], "dtype": "bfloat16",
              "max_batch": max_batch, "clients": clients,
              "requests": len(reqs), "img_per_s": len(reqs) / seconds,
              "latency_ms": {"p50": float(lat[len(lat) // 2]),
                             "p95": float(lat[int(len(lat) * 0.95)])},
              "mean_batch_fill": stats["mean_batch_fill"],
              "batch_size_histogram": stats["batch_size_histogram"],
              "dispatch_ms": stats["dispatch_ms"],
              "assemble_ms": stats["assemble_ms"],
              "scatter_ms": stats["scatter_ms"], **card})
    del pipe
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    set_counts(attention_cuda, saved)

    kernels = []
    for dt in (torch.float32, torch.bfloat16):
        Q, V, keep, ksc = main_inputs[(1, 64, dt)]   # as on the main path
        assert Q is V
        B, N, D = Q.shape
        P = V.shape[1]
        f32 = torch.float32                     # the main path's output dtype
        n0 = attention_cuda.LAUNCHES
        k_ms = cuda_ms(lambda: attention_core(Q, V, V, keep, out_dtype=f32,
                                              kscale=ksc), reps=20)
        attention_cuda.LAUNCHES = n0            # timing launches do not count
        p_ms = cuda_ms(lambda: attention_core_reference(
            Q, V, V, keep, out_dtype=f32, kscale=ksc), reps=20)
        Ks = (V.float() * ksc[:, None, :] * (10.0 * keep)[..., None]).to(dt)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            Q, Ks, V, scale=1.0), reps=20)
        # each input read once (Q and K are V), the float32 output written
        nbytes = B * (Q.element_size() * P * D + 4 * (N * D + P + D))
        flops = 4.0 * B * N * P * D
        t_bytes = nbytes / peaks["bytes"] * 1e3
        t_ops = ops_ms(flops, str(dt).split(".")[-1], peaks)
        tag = f"B1_64sq_{str(dt).split('.')[-1]}"
        kernels.append({
            "name": "contextual_attention_fwd"
                    + ("" if dt == torch.float32 else "[bf16]"),
            "route": "cuda",
            "source": "sketchedit_tpu_torch/csrc/contextual_attention_fwd.cu",
            "replaces": "sketchedit_tpu/ops/attention_pallas.py:53",
            "launches": launches[str(dt).split(".")[-1]] + (
                multi_launches["fwd"] if dt == torch.float32
                else conv_launches["fwd"])
                + art_launches[str(dt).split(".")[-1]]
                + pack_launches[str(dt).split(".")[-1]]["fwd"],
            "packing_launches": pack_launches[str(dt).split(".")[-1]]["fwd"],
            **({"validation_launches": val_launches["fwd"]}
               if dt == torch.float32
               else {"convergence_launches": conv_launches["fwd"]}),
            "artifact_launches": art_launches[str(dt).split(".")[-1]],
            "max_abs_err": errs[tag],
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": lib_ms,
            "shape_BNPD": [B, N, P, D], "dtype": str(dt).split(".")[-1],
            "peaks_assumed": part, **card})
    for dt in (torch.float32, torch.bfloat16):
        # the forward variants: the shared kernel at the served 256^2, the
        # D-split kernel at its own --edit_size 512; launches from the
        # in-process serving runs under each switch
        name = str(dt).split(".")[-1]
        for k, hw, src_line in (("shared", 64, 103), ("dsplit", 128, 156)):
            row = fwd_times[(1, hw, dt)]
            kernels.append({
                "name": f"contextual_attention_fwd_{k}"
                        + ("" if dt == torch.float32 else "[bf16]"),
                "route": "cuda",
                "source": "sketchedit_tpu_torch/csrc/contextual_attention_fwd.cu",
                "replaces": f"sketchedit_tpu/ops/attention_pallas.py:{src_line}",
                "launches": serve_launches[(k, 4 * hw, name)] + (
                    variant_art_launches[k] if dt == torch.float32 else 0),
                "max_abs_err": variant_errs[(k, f"B1_{hw}sq_{name}")],
                "ms": row[f"{k}_ms"],
                "plain_ms": row["plain_ms"],
                **({"dsplit_plain_ms": row["dsplit_plain_ms"]}
                   if k == "dsplit" else {}),
                "bound_ms": row[f"{k}_bound_ms"],
                "bound_by": row[f"{k}_bound_by"],
                "library_ms": row["library_ms"],
                "shape_BNPD": row["shape_BNPD"], "dtype": name,
                "peaks_assumed": part, **card})
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        row = bwd_times[(8, dt)]       # the training path's shapes
        # the train steps under each switch in this dtype (the joint
        # backward by default and under SHARED_ATTN; dQ, dV and dK under
        # SPLIT_DKDV). The joint row stands for _dkdv_kernel too: no route
        # runs the standalone fused dK/dV, which check_bwd and
        # time_bwd_kernel hold to its plain version and time
        switched = [v for k, v in switch_launches.items()
                    if k.endswith("[bf16]") == (dt == torch.bfloat16)]
        for k, src_line in (("bwd", 262), ("dq", 262), ("dv", 350),
                            ("dk", 383)):
            kernels.append({
                "name": f"contextual_attention_{k}"
                        + ("" if dt == torch.float32 else "[bf16]"),
                "route": "cuda",
                "source": "sketchedit_tpu_torch/csrc/contextual_attention_bwd.cu",
                "replaces": f"sketchedit_tpu/ops/attention_pallas.py:{src_line}",
                **({"also_replaces": "sketchedit_tpu/ops/attention_pallas.py:304"}
                   if k == "bwd" else {}),
                "launches": train_launches[name][k]
                + sum(n[k] for n in switched) + (
                    multi_launches[k] if dt == torch.float32
                    else conv_launches[k]) + pack_launches[name][k],
                "max_abs_err": bwd_errs[f"B8_64sq_{name}"][k],
                "ms": row[f"{k}_ms"], "plain_ms": row[f"{k}_plain_ms"],
                "bound_ms": row[f"{k}_bound_ms"],
                "bound_by": row[f"{k}_bound_by"],
                "library_ms": row["library_ms"],
                "shape_BNPD": row["shape_BNPD"], "dtype": name,
                "peaks_assumed": part, **card})
    for (B, hw, dt), (Q, V, keep, ksc) in main_inputs.items():
        n0 = attention_cuda.LAUNCHES
        emit({"phase": "time_kernel", "shape_BNPD": [B, Q.shape[1],
                                                     V.shape[1], Q.shape[2]],
              "dtype": str(dt).split(".")[-1], **card,
              "kernel_ms": cuda_ms(lambda: attention_core(
                  Q, V, V, keep, out_dtype=torch.float32, kscale=ksc), 10),
              "plain_ms": cuda_ms(lambda: attention_core_reference(
                  Q, V, V, keep, out_dtype=torch.float32, kscale=ksc), 10)})
        attention_cuda.LAUNCHES = n0
    assert all(k["launches"] > 0 for k in kernels), [
        k["name"] for k in kernels if not k["launches"]]
    emit({"kernels": kernels})
    emit({"phase": "total", "seconds": round(time.perf_counter() - t_start, 1),
          **card})

    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
