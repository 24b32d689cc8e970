#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sketchedit_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--out results.jsonl]

Phases, in order; any failure raises and the exit code is not 0:

1. device: torch and CUDA versions, the card's name and power limit;
2. build: nvcc builds every kernel in sketchedit_tpu_torch/csrc;
3. kernels vs plain: the contextual-attention forward kernel, then the dQ
   and dK/dV backward kernels, against their plain PyTorch versions at the
   main paths' shapes (inference 256^2 B = 1 and 4, training 256^2 B = 1
   and 8), float32 and bfloat16, plus a ragged and an all-gated case;
4. inference path: the runner's EditPipeline on uint8 batches at 256^2
   (B = 1 and 4, float32 and bfloat16) and 252^2, one forward launch per
   netG forward, checked against the same pipeline with dense attention
   and, at 64^2, against the port on the CPU;
5. train step: one G+D step at 256^2, B = 8, per branch flag, through the
   kernels and through the dense attention (losses and every gradient
   compared, launches counted), the bfloat16 step's gradients held to the
   float32 ones, and the step on the GPU against the step on the CPU;
6. training path: the train loop, 5 steps at 256^2, B = 8, in float32 and
   bfloat16 on batches from the editimage loader (synthetic PNGs), with
   the launch counts of the forward and both backward kernels, and a saved
   checkpoint reloaded; then the train CLI for 2 steps;
7. CLI: the batch inference CLI with test_celeb.sh's flags;
8. times: CUDA events after warm-up (inference and train step, each
   kernel, its plain version and one PyTorch call computing the same
   function); one JSON line per item, and the `kernels` line.

The weights are random, drawn from --seed: kaiming init scaled by 1.8
(netM) and 1.5 (netG), since kaiming alone lets the gated activations
shrink every output to within 1e-3 of its midpoint, which would make the
checks vacuous. The last line is the JSON result; nothing of it is printed
when CUDA is unavailable or the package is missing.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

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
# Published dense peaks (NVIDIA data sheets): float32 outside the tensor
# cores and bfloat16 on them, FLOP/s; memory, bytes/s.
PEAKS = {
    "PCIe": {"float32": 51.2e12, "bfloat16": 756e12, "bytes": 2.0e12},
    "NVL": {"float32": 60e12, "bfloat16": 835e12, "bytes": 3.9e12},
    "SXM": {"float32": 67e12, "bfloat16": 989e12, "bytes": 3.35e12},
}
# by the kernel's output dtype: float32 differs from the plain version by
# summation order only; a bfloat16 output adds its own rounding
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# backward kernels vs plain, as a share of each gradient's max |value|:
# float32 arithmetic and outputs on both sides for either input type, with
# S recomputed in another summation order
BWD_TOL = 2e-4
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

lines: list[str] = []


def emit(obj):
    line = json.dumps(obj)
    lines.append(line)
    print(line, flush=True)


def card_peaks(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, PEAKS[key]
    return "SXM", PEAKS["SXM"]


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


def counts(ac):
    """The launch counters: forward (with lse), dQ, dK/dV."""
    return {"fwd": ac.LAUNCHES, "fwd_lse": ac.LAUNCHES_LSE,
            "dq": ac.LAUNCHES_DQ, "dkdv": ac.LAUNCHES_DKDV}


def zero_counts(ac):
    ac.LAUNCHES = ac.LAUNCHES_LSE = ac.LAUNCHES_DQ = ac.LAUNCHES_DKDV = 0


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
        attention_core, attention_core_dkdv, attention_core_dkdv_reference,
        attention_core_dq, attention_core_dq_reference,
        attention_core_reference, attention_inputs)
    from sketchedit_tpu_torch.options import parse_argv
    from sketchedit_tpu_torch.options.test_options import TestOptions
    from sketchedit_tpu_torch.runner import build_pipeline

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
    fa = features(rs, 1, 64, 64).to(dev)
    Q, V, keep, ksc = attention_inputs(fa, fa, torch.ones(1, 1, 64, 64,
                                                          device=dev))
    assert keep.sum().item() == 0
    check_core("all_gated", Q, V, V, keep, kscale=ksc)

    bwd_errs = {}
    bwd_inputs = {}

    def check_bwd(tag, Q, K, V, keep, kscale):
        """dQ and (dK_eff, dV) from the two kernels against their plain
        versions on the same inputs, the forward's lse and a random dO."""
        out, lse = attention_core(Q, K, V, keep, return_lse=True,
                                  out_dtype=torch.float32, kscale=kscale)
        dO = torch.randn(out.shape, generator=torch.Generator().manual_seed(
            args.seed)).to(dev)
        bargs = (Q, K, V, keep, lse, (dO * out).sum(-1), dO, 10.0, kscale)
        before = counts(attention_cuda)
        got = (attention_core_dq(*bargs), *attention_core_dkdv(*bargs))
        torch.cuda.synchronize()
        after = counts(attention_cuda)
        assert (after["dq"], after["dkdv"]) == (before["dq"] + 1,
                                                before["dkdv"] + 1), tag
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
        bwd_errs[tag] = {"dq": row["dQ_max_abs_err"],
                         "dkdv": max(row["dK_eff_max_abs_err"],
                                     row["dV_max_abs_err"])}
        emit(row)
        return bargs

    for B in (1, 8):      # the training path: 256^2 images, pm features 64^2
        f = features(rs, B, 64, 64).to(dev)
        m = hole_mask(B, 64, 64).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            fd = f.to(dt)
            Q, V, keep, ksc = attention_inputs(fd, fd, m)
            bwd_inputs[(B, dt)] = check_bwd(
                f"B{B}_64sq_{str(dt).split('.')[-1]}", Q, V, V, keep, ksc)
    check_bwd("unaligned_2x130x150x70", Qr, Kr, Vr, keep_r,
              torch.from_numpy((0.5 + rs.rand(2, 70)).astype(np.float32)
                               ).to(dev))
    Q, V, keep, ksc = attention_inputs(fa, fa, torch.ones(1, 1, 64, 64,
                                                          device=dev))
    check_bwd("all_gated", Q, V, V, keep, ksc)

    # 4. main path --------------------------------------------------------
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")   # removed at exit
    ckdir = os.path.join(tmp.name, "ck")

    def pipeline(dtype, impl, device="cuda"):
        with contextlib.redirect_stdout(io.StringIO()):
            opt = parse_argv(TestOptions, [
            "--name", "celeb", "--checkpoints_dir", ckdir, "--use_cam",
            "--pool_type", "max", "--joint_train_inp", "--init_type",
            "kaiming", "--device", device, "--compute_dtype", dtype,
            "--attention_impl", impl])
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
    zero_counts(attention_cuda)
    for (dt, B, H, W), (img, sk) in zip(cases, batches):
        before = attention_cuda.LAUNCHES
        composed, mask = pipes[dt](img, sk)
        assert attention_cuda.LAUNCHES == before + 1, "one launch per netG"
        launches[dt] += attention_cuda.LAUNCHES - before
        results.append((composed, mask))
    assert attention_cuda.LAUNCHES == len(cases) and all(launches.values())
    c = counts(attention_cuda)
    assert c["fwd_lse"] == c["dq"] == c["dkdv"] == 0, c

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

    # 5. train step --------------------------------------------------------
    from sketchedit_tpu_torch.cli.train import train_loop
    from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
    from sketchedit_tpu_torch.params import checkpoint as ckpt
    from sketchedit_tpu_torch.train import trainer as tr

    def train_state(dtype, impl, device="cuda", precision="highest"):
        cfg = tr.TrainConfig(netg=DeepFillConfig(attention_impl=impl),
                             compute_dtype=dtype, precision=precision)
        state = tr.init_train_state(cfg, seed=args.seed, device=device)
        scale_weights_(state.nets["M"], state.nets["G"])
        return state, cfg

    def one_step(dtype, impl, batch, flags, device="cuda"):
        """One train_step from a fresh state (its metrics and launch
        counts), and its gradients: the step's two halves on another fresh
        state, the D half before the G update, so that both attention paths
        regenerate the fakes from the same generator weights (after the
        update they differ where Adam's first step takes the sign of a
        noise-level gradient)."""
        state, cfg = train_state(dtype, impl, device)
        before = counts(attention_cuda)
        _, metrics = tr.train_step(state, tr.batch_to_device(batch, device),
                                   *flags, cfg)
        if device == "cuda":
            torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in counts(attention_cuda).items()}
        state, cfg = train_state(dtype, impl, device)
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
    for flag in (0, 1, 2):
        m_k, g_k, n_k = one_step("float32", "kernel", batch8, (flag, flag))
        m_d, g_d, n_d = one_step("float32", "dense", batch8, (flag, flag))
        # one forward with lse, one dQ and one dK/dV in the G step; one
        # forward without lse in the D step's regeneration of the fakes
        assert n_k == {"fwd": 2, "fwd_lse": 1, "dq": 1, "dkdv": 1}, n_k
        assert not any(n_d.values()), n_d
        loss_diff = losses_agree(m_k, m_d)
        worst = grad_errors(g_k, g_d)
        emit({"phase": "train_step_kernel_vs_dense", "hw": [256, 256],
              "batch": 8, "dtype": "float32", "flag": flag, "losses": m_k,
              "max_loss_rel_diff": loss_diff, "grad_err": worst,
              "grad_tol": GRAD_TOL, "launches": n_k})

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
    for i in range(40):
        arr = (r.rand(256, 256, 3) * 255).astype(np.uint8)
        arr[r.randint(0, 200):, r.randint(0, 200):] //= 3   # some edges
        Image.fromarray(arr).save(os.path.join(pngs, f"{i:03d}.png"))
    ns = argparse.Namespace(
        train_image_dir=pngs, train_image_list=None,
        preprocess_mode="resize_and_crop", load_size=256, crop_size=256,
        aspect_ratio=1.0, isTrain=True, no_flip=False, canny_low=100,
        canny_high=200, decode_cache_mb=512, not_om=True, cjit=None,
        batchSize=8, serial_batches=False, dataset_mode="editimage",
        checkpoints_dir=os.path.join(tmp.name, "train_ck"), name="smoke")
    with contextlib.redirect_stdout(io.StringIO()):
        loader = data_mod.create_dataloader(ns)
    assert len(loader) == 5
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
        assert len(seen) == 5 and state.step == 5
        assert used == {"fwd": 10, "fwd_lse": 5, "dq": 5, "dkdv": 5}, used
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
              "dtype": dt, "steps": 5, "seconds": round(loop_s, 3),
              "launches": used, "first_losses": losses[0],
              "last_losses": losses[-1], "params_changed": True,
              "checkpoint_reloads": True})

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

    # 8. times ------------------------------------------------------------
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
    for dt, tf32 in (("float32", False), ("float32", True),
                     ("bfloat16", False)):
        state, cfg = train_state(dt, "auto")
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        ms = cuda_ms(lambda: tr.train_step(state, tb, 1, 1, cfg), reps=3,
                     warmup=1)
        emit({"phase": "time_train_step", "hw": [256, 256], "batch": 8,
              "dtype": dt, "tf32": tf32, "ms_per_step": ms,
              "img_per_s": 8000.0 / ms, **card})
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

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
        row["dq_plain_ms"] = cuda_ms(
            lambda: attention_core_dq_reference(*bargs), reps=10)
        row["dkdv_plain_ms"] = cuda_ms(
            lambda: attention_core_dkdv_reference(*bargs), reps=10)
        Kg = (V.float() * ksc[:, None, :] * (10.0 * keep)[..., None]).to(dt)
        q_, k_, v_ = (t.detach().clone().requires_grad_() for t in (Q, Kg, V))
        o_ = F.scaled_dot_product_attention(q_, k_, v_, scale=1.0)
        g_ = dO.to(o_.dtype)
        row["library_ms"] = cuda_ms(lambda: torch.autograd.grad(
            o_, (q_, k_, v_), g_, retain_graph=True), reps=10)
        del o_
        # the work this run's data needs: S and dP over every key, dV over
        # every key (P > 0 for a gated key too), dS-products over the kept
        # keys only; each input read once (Q, K and V are one tensor), each
        # output written once
        kept = keep.sum().item()
        nprod = 2.0 * B * N * P * D
        flops = {"dq": 2 * nprod + 2.0 * N * D * kept,
                 "dkdv": 3 * nprod + 2.0 * N * D * kept}
        inputs = B * (Q.element_size() * P * D + 4 * (P + D + N * D + 2 * N))
        nbytes = {"dq": inputs + 4 * B * N * D, "dkdv": inputs + 8 * B * P * D}
        peak = peaks[str(dt).split(".")[-1]]
        for k in ("dq", "dkdv"):
            t_ops = flops[k] / peak * 1e3
            t_bytes = nbytes[k] / peaks["bytes"] * 1e3
            row[f"{k}_bound_ms"] = max(t_ops, t_bytes)
            row[f"{k}_bound_by"] = "bytes" if t_bytes > t_ops else "operations"
            row[f"{k}_gflop"] = flops[k] / 1e9
        bwd_times[(B, dt)] = row
        emit(row)
    for k, v in saved.items():               # timing launches do not count
        setattr(attention_cuda, {"fwd": "LAUNCHES", "fwd_lse": "LAUNCHES_LSE",
                                 "dq": "LAUNCHES_DQ",
                                 "dkdv": "LAUNCHES_DKDV"}[k], v)

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
        t_ops = flops / peaks[str(dt).split(".")[-1]] * 1e3
        tag = f"B1_64sq_{str(dt).split('.')[-1]}"
        kernels.append({
            "name": "contextual_attention_fwd"
                    + ("" if dt == torch.float32 else "[bf16]"),
            "route": "cuda",
            "source": "sketchedit_tpu_torch/csrc/contextual_attention_fwd.cu",
            "replaces": "sketchedit_tpu/ops/attention_pallas.py:53",
            "launches": launches[str(dt).split(".")[-1]],
            "max_abs_err": errs[tag],
            "ms": k_ms, "kernel_ms": k_ms, "plain_ms": p_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": lib_ms,
            "shape_BNPD": [B, N, P, D], "dtype": str(dt).split(".")[-1],
            "peaks_assumed": part, **card})
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[-1]
        row = bwd_times[(8, dt)]       # the training path's shapes
        for k, src_line in (("dq", 262), ("dkdv", 304)):
            kernels.append({
                "name": f"contextual_attention_{k}"
                        + ("" if dt == torch.float32 else "[bf16]"),
                "route": "cuda",
                "source": "sketchedit_tpu_torch/csrc/contextual_attention_bwd.cu",
                "replaces": f"sketchedit_tpu/ops/attention_pallas.py:{src_line}",
                "launches": train_launches[name][k],
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
