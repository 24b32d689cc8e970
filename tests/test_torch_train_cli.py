"""The port's train CLI on the CPU: two steps on four 32^2 PNGs, checkpoints
that the JAX package loads (its forward then matches the port's), an exact
resume of the training state, held-out validation with the metrics log and
best checkpoints (loaded through the spawned loader pool), checkpoint-and-
exit on SIGTERM, and the refusal of the default device without a GPU.
Forward tolerance: atol 1e-4, float32 on both sides."""

import argparse
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from sketchedit_tpu.models import deepfill_c2 as j_g
from sketchedit_tpu.models import discriminator as j_d
from sketchedit_tpu.models import md_generator as j_m
from sketchedit_tpu.params import checkpoint as j_ckpt
from sketchedit_tpu_torch import data
from sketchedit_tpu_torch.cli import train as cli
from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillC2Generator
from sketchedit_tpu_torch.models.discriminator import Discriminator
from sketchedit_tpu_torch.models.md_generator import MDGenerator
from sketchedit_tpu_torch.params import checkpoint as ckpt
from sketchedit_tpu_torch.train import trainer as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIGH = jax.lax.Precision.HIGHEST


def _pngs(directory, n=4, size=32):
    directory.mkdir()
    rs = np.random.RandomState(0)
    for i in range(n):
        arr = (rs.rand(size, size, 3) * 255).astype(np.uint8)
        arr[size // 4:size // 2] = 255
        Image.fromarray(arr).save(directory / f"{i}.png")
    return directory


def _flags(imgs, ck, name, *extra):
    return ["--name", name, "--checkpoints_dir", str(ck),
            "--dataset_mode", "editimage", "--train_image_dir", str(imgs),
            "--batchSize", "2", "--use_cam", "--pool_type", "max",
            "--joint_train_inp", "--not_om", "--preprocess_mode",
            "resize_and_crop", "--load_size", "32", "--crop_size", "32",
            "--no_flip", "--save_epoch_freq", "1", "--print_freq", "2",
            *extra]


def _run_cli(args, timeout=300, env=None):
    # one intra-op thread: at 32^2 more threads only add contention, which
    # the parallel test workers multiply
    return subprocess.run(
        [sys.executable, "-m", "sketchedit_tpu_torch.cli.train", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO,
        env={**os.environ, "OMP_NUM_THREADS": "1", **(env or {})})


def _rows(run_dir):
    with open(run_dir / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_cli_two_steps_and_jax_loads_the_checkpoints(tmp_path):
    imgs = _pngs(tmp_path / "imgs")
    res = _run_cli(_flags(imgs, tmp_path / "ck", "t", "--niter", "1",
                          "--device", "cpu"))
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    assert res.stdout.count(" ms/img) {") == 2        # two steps printed
    assert "End of epoch 1 / 1" in res.stdout
    run = tmp_path / "ck" / "t"
    files = set(os.listdir(run))
    for label in "MGD":
        assert {f"latest_net_{label}.npz", f"1_net_{label}.npz"} <= files
    assert {"train_state_latest.pt", "iter.txt", "opt.json"} <= files
    # --metrics_log defaults to auto: one train row per print
    rows = _rows(run)
    assert [(r["kind"], r["epoch"], r["iter"]) for r in rows] == [
        ("train", 1, 2), ("train", 1, 4)]
    assert set(rows[0]["losses"]) >= {"G_total", "L1f", "D_Fake"}
    assert not any(f.startswith("best_") for f in files)

    # the JAX package reads the .npz files; its forward equals the port's
    rs = np.random.RandomState(1)
    img = rs.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    sk = (rs.rand(1, 32, 32, 1) > 0.9).astype(np.float32)
    mask = np.zeros((1, 32, 32, 1), np.float32)
    mask[:, 8:24, 8:24] = 1.0
    t = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))
         for a in (img, sk, mask)]
    ji = [jnp.asarray(a) for a in (img, sk, mask)]
    nets = {"M": MDGenerator(), "G": DeepFillC2Generator(),
            "D": Discriminator()}
    jparams = {}
    for label, net in nets.items():
        path = str(run / f"latest_net_{label}.npz")
        net.load_state_dict(ckpt.load_network_path(path), strict=True)
        jparams[label] = j_ckpt.load_network_path(path)
    with torch.no_grad():
        got = [*nets["M"](t[0], t[1]),
               *nets["G"](t[0], t[0], t[2], t[2], t[1]),
               nets["D"](t[0], t[2], t[0])]
    want = [*j_m.apply(jparams["M"], ji[0], ji[1], precision=HIGH),
            *j_g.apply(jparams["G"], ji[0], ji[0], ji[2], ji[2], ji[1],
                       precision=HIGH),
            j_d.apply(jparams["D"], ji[0], ji[2], ji[0], precision=HIGH)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1),
                                   np.asarray(w), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(nets["D"].dconv3.u.numpy(),
                                  np.asarray(jparams["D"]["dconv3"]["u"]))


def test_resume_is_exact(tmp_path):
    """1 step + save + resume into a differently seeded state + 1 step
    equals 2 steps: parameters, u buffers, Adam moments, the step and the
    branch-flag stream."""
    imgs = _pngs(tmp_path / "imgs")
    ns = argparse.Namespace(
        train_image_dir=str(imgs), train_image_list=None,
        preprocess_mode="resize_and_crop", load_size=32, crop_size=32,
        aspect_ratio=1.0, isTrain=True, no_flip=True, canny_low=100,
        canny_high=200, decode_cache_mb=1, not_om=True, cjit=None,
        batchSize=2, serial_batches=True, dataset_mode="editimage",
        nThreads=0, checkpoints_dir=str(tmp_path / "ck"), name="r")
    batches = list(data.create_dataloader(ns))
    assert len(batches) == 2 and batches[0]["image"].dtype == np.uint8
    cfg = tr.TrainConfig()

    full = tr.init_train_state(cfg, seed=1, flag_seed=2,
                              device="cpu")
    cli.train_loop(full, batches, cfg)
    half = tr.init_train_state(cfg, seed=1, flag_seed=2,
                              device="cpu")
    cli.train_loop(half, batches[:1], cfg)
    ckpt.save_train_state(half, ns)
    resumed = tr.init_train_state(cfg, seed=7, flag_seed=8,
                                 device="cpu")
    assert ckpt.load_train_state(ns, resumed)
    assert not ckpt.load_train_state(
        argparse.Namespace(checkpoints_dir=str(tmp_path), name="none"),
        resumed)
    cli.train_loop(resumed, batches[1:], cfg)

    assert resumed.step == full.step == 2
    assert torch.equal(resumed.flag_rng.get_state(), full.flag_rng.get_state())
    for label in "MGD":
        a, b = full.nets[label].state_dict(), resumed.nets[label].state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), (label, k)
    for oa, ob in ((full.opt_g, resumed.opt_g), (full.opt_d, resumed.opt_d)):
        sa, sb = oa.state_dict()["state"], ob.state_dict()["state"]
        assert sa.keys() == sb.keys()
        for i in sa:
            for k in sa[i]:
                assert torch.equal(torch.as_tensor(sa[i][k]),
                                   torch.as_tensor(sb[i][k])), (i, k)


def test_cli_sigterm_checkpoints_and_exits(tmp_path):
    imgs = _pngs(tmp_path / "imgs")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sketchedit_tpu_torch.cli.train",
         *_flags(imgs, tmp_path / "ck", "sig", "--niter", "500",
                 "--save_epoch_freq", "1000", "--device", "cpu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
    try:
        deadline = time.time() + 240
        for line in proc.stdout:
            if "ms/img" in line:
                break
            assert time.time() < deadline and proc.poll() is None, line
        proc.send_signal(signal.SIGTERM)
        out = proc.stdout.read()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 128 + signal.SIGTERM, (rc, out[-2000:])
    assert "checkpointed on signal 15" in out
    files = set(os.listdir(tmp_path / "ck" / "sig"))
    assert {"latest_net_M.npz", "latest_net_G.npz", "latest_net_D.npz",
            "train_state_latest.pt", "iter.txt"} <= files


def test_cli_validation_writes_val_rows_and_best_nets(tmp_path):
    """--val_image_dir over 2 epochs with --nThreads 2 (the forced spawn
    pool): train and val rows in metrics.jsonl, best_net_{M,G,D} equal to
    the epoch of the last improvement; --continue_train recovers the
    best value from the log."""
    imgs = _pngs(tmp_path / "imgs")
    ck = tmp_path / "ck"
    flags = _flags(imgs, ck, "val", "--device", "cpu", "--val_image_dir",
                   str(imgs), "--val_items", "3", "--nThreads", "2")
    force = {"SKETCHEDIT_FORCE_PROCESS_WORKERS": "1"}
    res = _run_cli([*flags, "--niter", "2"], env=force)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    assert "loader: processes, nThreads 2" in res.stdout
    assert "validation: 3 held-out items" in res.stdout
    run = ck / "val"
    rows = _rows(run)
    assert [(r["kind"], r["epoch"]) for r in rows] == [
        ("train", 1), ("train", 1), ("val", 1),
        ("train", 2), ("train", 2), ("val", 2)]
    val = [r for r in rows if r["kind"] == "val"]
    assert all(np.isfinite(r[k]) for r in val for k in
               ("psnr", "ssim", "region_psnr", "region_l1", "outside_l1",
                "mask_iou"))
    assert val[0]["best"] is True
    assert val[1].get("best", False) == (val[1]["psnr"] > val[0]["psnr"])
    best_epoch = 2 if val[1].get("best") else 1
    for label in "MGD":
        with np.load(run / f"best_net_{label}.npz") as best, \
                np.load(run / f"{best_epoch}_net_{label}.npz") as want:
            assert best.files == want.files
            for k in best.files:
                np.testing.assert_array_equal(best[k], want[k])

    # the resumed run has no epoch left to train: it only starts up
    res = _run_cli([*flags, "--niter", "2", "--continue_train"], env=force)
    assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-3000:])
    best_psnr = max(r["psnr"] for r in val)
    assert f"resumed best psnr = {best_psnr}" in res.stdout
    assert _rows(run) == rows


@pytest.mark.parametrize("extra,error,match", [
    ((), RuntimeError, "CUDA is not available"),
])
def test_cli_refusals(tmp_path, monkeypatch, extra, error, match):
    if not extra and torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid")
    imgs = _pngs(tmp_path / "imgs")
    monkeypatch.setattr(sys, "argv", [
        "train", *_flags(imgs, tmp_path / "ck", "refuse", "--niter", "1"),
        *extra])
    with pytest.raises(error, match=match):
        cli.main()
