#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sketchedit_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed 0] [--out results.jsonl]

Phases, in order; any failure raises and the exit code is not 0:

1. device: torch and CUDA versions, the card's name and power limit;
2. build: nvcc builds every kernel in sketchedit_tpu_torch/csrc;
3. kernel vs plain: the contextual-attention kernel against its plain
   PyTorch version at the main path's shapes, float32 and bfloat16;
4. main path: the runner's EditPipeline on uint8 batches at 256^2 (B = 1
   and 4, float32 and bfloat16) and 252^2, one kernel launch per netG
   forward, checked against the same pipeline with dense attention and,
   at 64^2, against the port on the CPU;
5. CLI: the batch CLI with test_celeb.sh's flags on two synthetic pairs;
6. times: CUDA events after warm-up; one JSON line per item.

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


def scale_weights_(model):
    with torch.no_grad():
        for net, gain in ((model.netM, GAIN_M), (model.netG, GAIN_G)):
            for conv in net.children():
                conv.weight.mul_(gain)


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
        attention_core, attention_core_reference, attention_inputs)
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
        scale_weights_(p.model)
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
    attention_cuda.LAUNCHES = 0
    for (dt, B, H, W), (img, sk) in zip(cases, batches):
        before = attention_cuda.LAUNCHES
        composed, mask = pipes[dt](img, sk)
        assert attention_cuda.LAUNCHES == before + 1, "one launch per netG"
        launches[dt] += attention_cuda.LAUNCHES - before
        results.append((composed, mask))
    assert attention_cuda.LAUNCHES == len(cases) and all(launches.values())

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

    # 5. CLI --------------------------------------------------------------
    from PIL import Image
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

    # 6. times ------------------------------------------------------------
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
