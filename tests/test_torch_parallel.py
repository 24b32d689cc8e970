"""The port's multi-device paths against the JAX package's on the CPU (the
conftest's 8 virtual JAX devices; the port's "devices" are the CPU named
two or three times): query-sharded contextual attention and netG with
``attention_impl='sharded'`` against the JAX ``shard_map`` over a patch
mesh, the two-replica ``EditPipeline`` against the JAX pipeline on a
two-device batch mesh, a two-rank gloo train step against the JAX step on
a two-device mesh, the ranks' loader rows, the train CLI on two ranks, and
the refusal of a rank count that does not divide the batch.

Tolerances, float32 on both sides: attention forward 1e-5 and gradient
1e-4 (absolute, values of order 1); netG 2e-4 (test_parallel.py's); uint8
within 1 LSB; the train step test_parallel.py:206's (metrics rtol 1e-4 /
atol 1e-5, conv1 weights rtol 1e-4 / atol 1e-5).
"""

import argparse
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import threading
import time
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from sketchedit_tpu.models import deepfill_c2 as j_g
from sketchedit_tpu.models import discriminator as j_d
from sketchedit_tpu.options.test_options import TestOptions as JaxTestOptions
from sketchedit_tpu.parallel.mesh import BATCH_AXIS, data_parallel_mesh
from sketchedit_tpu.parallel.sharded_attention import (
    contextual_attention_sharded as j_sharded, patch_mesh)
from sketchedit_tpu.runner import build_pipeline as j_build_pipeline
from sketchedit_tpu.train import trainer as j_tr
from sketchedit_tpu_torch import data
from sketchedit_tpu_torch.cli import train as cli
from sketchedit_tpu_torch.models.deepfill_c2 import (
    DeepFillC2Generator, DeepFillConfig)
from sketchedit_tpu_torch.options import parse_argv
from sketchedit_tpu_torch.ops import attention_cuda
from sketchedit_tpu_torch.options.test_options import TestOptions
from sketchedit_tpu_torch.parallel import distributed, mesh
from sketchedit_tpu_torch.parallel.sharded_attention import (
    contextual_attention_sharded)
from sketchedit_tpu_torch.params import checkpoint as ckpt
from sketchedit_tpu_torch.params.convert import (
    jax_params_to_state_dict, state_dict_to_jax_params)
from sketchedit_tpu_torch.runner import build_pipeline
from sketchedit_tpu_torch.server.executor import BatchingExecutor
from sketchedit_tpu_torch.train import trainer as tr
from test_torch_edit import jax_params, port_model   # scaled kaiming weights
from torch_dp_ranks import port_state, rank_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIGH = jax.lax.Precision.HIGHEST
CPU = torch.device("cpu")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def test_mesh_helpers_pad_gather_and_replicate():
    assert mesh.data_parallel_devices(2, ["cpu"] * 3) == [CPU, CPU]
    with pytest.raises(ValueError, match="requested 4 devices, have 3"):
        mesh.data_parallel_devices(4, ["cpu"] * 3)
    x = torch.arange(5 * 2.0).reshape(5, 2)
    shards, pad = mesh.shard_batch([CPU] * 2, x, x + 1)
    assert pad == 1 and [s[0].shape[0] for s in shards] == [3, 3]
    np.testing.assert_array_equal(shards[1][0][-1], x[-1])  # the repeat
    assert torch.equal(mesh.gather([s[1] for s in shards], CPU, pad), x + 1)
    net = torch.nn.Linear(2, 2)
    copies = mesh.replicate(net, [CPU, CPU])
    assert len(copies) == 2 and copies[0] is not net
    assert all(torch.equal(c.weight, net.weight) for c in copies)


def test_launch_counters_lose_no_update_across_threads():
    """Pipeline replicas launch from several threads: 16 threads adding to
    one counter with a tiny switch interval lose no increment."""
    saved = (attention_cuda.LAUNCHES, sys.getswitchinterval())
    sys.setswitchinterval(1e-6)
    try:
        attention_cuda.LAUNCHES = 0
        threads = [threading.Thread(target=lambda: [
            attention_cuda._count("LAUNCHES") for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert attention_cuda.LAUNCHES == 16 * 2000
    finally:
        attention_cuda.LAUNCHES = saved[0]
        sys.setswitchinterval(saved[1])


@pytest.mark.parametrize("n_shards", [2, 3])
def test_sharded_attention_matches_jax(n_shards):
    """H = 18, C = 6 (64 query patches; 3 shards are uneven): forward within
    1e-5, the features' gradient of sum(out * w) within 1e-4, against the
    JAX shard_map over a patch mesh of as many devices."""
    H, C = 18, 6
    rs = np.random.RandomState(0)
    f = rs.randn(2, H, H, C).astype(np.float32)
    mask = (rs.rand(2, H, H, 1) > 0.5).astype(np.float32)
    w = rs.uniform(-1, 1, (2, H, H, C)).astype(np.float32)
    pm = patch_mesh(n_shards)

    def j_loss(x):
        return jnp.sum(j_sharded(x, x, jnp.asarray(mask), pm,
                                 precision=HIGH) * w)

    want = np.asarray(j_sharded(jnp.asarray(f), jnp.asarray(f),
                                jnp.asarray(mask), pm, precision=HIGH))
    want_g = np.asarray(jax.grad(j_loss)(jnp.asarray(f)))

    ft = _nchw(f).requires_grad_()
    out = contextual_attention_sharded(ft, ft, _nchw(mask), [CPU] * n_shards)
    (g,) = torch.autograd.grad((out * _nchw(w)).sum(), ft)
    np.testing.assert_allclose(_nhwc(out), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_nhwc(g), want_g, rtol=0, atol=1e-4)
    assert np.abs(want_g).max() > 0.1

    fb = _nchw(f).bfloat16()
    assert contextual_attention_sharded(
        fb, fb, _nchw(mask), [CPU] * n_shards).dtype == torch.bfloat16


def test_netg_sharded_matches_jax_and_the_kernel_path():
    """netG at 64^2 (49 query patches over 2 shards) against the JAX netG
    with a 2-device patch mesh; its gradients against the unsharded kernel
    path's."""
    params = jax_params(4)["G"]
    rs = np.random.RandomState(21)
    x = rs.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    m = np.zeros((1, 64, 64, 1), np.float32)
    m[:, 16:48, 20:44] = 1.0
    want = j_g.apply(params, x, x, m, m, precision=HIGH,
                     config=j_g.DeepFillConfig(attention_impl="sharded",
                                               attention_mesh=patch_mesh(2)))
    nets = {}
    for impl, devices in (("sharded", (CPU, CPU)), ("kernel", ())):
        net = DeepFillC2Generator(DeepFillConfig(attention_impl=impl,
                                                 attention_devices=devices))
        net.load_state_dict(jax_params_to_state_dict(params), strict=True)
        nets[impl] = net
    xt, mt = _nchw(x), _nchw(m)
    outs = {impl: net(xt, xt, mt, mt) for impl, net in nets.items()}
    for got, w in zip(outs["sharded"], want):
        np.testing.assert_allclose(_nhwc(got), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)
    assert np.asarray(want[1]).std() > 0.05
    grads = {impl: torch.autograd.grad(
        (o[1] - xt).abs().mean() + 0.5 * (o[0] - xt).abs().mean(),
        list(nets[impl].parameters())) for impl, o in outs.items()}
    for a, b in zip(grads["sharded"], grads["kernel"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    # the loss reaches the layers before the attention through it
    i = [n for n, _ in nets["sharded"].named_parameters()].index(
        "pmconv1.weight")
    assert grads["sharded"][i].abs().max() > 0


def _options(cls, tmp, *extra, parse=parse_argv):
    return parse(cls, ["--name", "dp", "--checkpoints_dir", str(tmp),
                       "--dataset_mode", "base", "--use_cam", "--pool_type",
                       "max", "--joint_train_inp", *extra], save=False)


def _jax_parse(cls, argv, save=False):
    saved = sys.argv
    sys.argv = ["prog", *argv]
    try:
        return cls().parse()
    finally:
        sys.argv = saved


def test_replicated_pipeline_matches_the_jax_data_parallel_pipeline(tmp_path):
    """build_pipeline with --data_parallel 2 (two replicas on the CPU) on a
    uint8 batch of 3, so the pad is taken, against the JAX build_pipeline
    with --data_parallel 2 (a two-device batch mesh) on the same
    checkpoints: uint8 within 1 LSB; also --attention_impl sharded."""
    params = jax_params(5)
    model = port_model(params)
    opt = _options(TestOptions, tmp_path, "--device", "cpu")
    ckpt.save_pipeline({"M": model.netM, "G": model.netG}, "latest", opt)
    dp = build_pipeline(_options(TestOptions, tmp_path, "--device", "cpu",
                                 "--data_parallel", "2"))
    sharded = build_pipeline(_options(
        TestOptions, tmp_path, "--device", "cpu", "--data_parallel", "2",
        "--attention_impl", "sharded"))
    assert [d for _, d in dp.replicas] == [CPU, CPU]
    assert dp.replicas[1][0] is not dp.model
    assert sharded.replicas == []
    assert sharded.config.netg.attention_devices == (CPU, CPU)
    j_pipe = j_build_pipeline(_options(JaxTestOptions, tmp_path,
                                       "--data_parallel", "2",
                                       parse=_jax_parse))
    assert j_pipe.mesh is not None
    rs = np.random.RandomState(5)
    img = rs.randint(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    sk = ((rs.rand(3, 32, 32, 1) > 0.9) * 255).astype(np.uint8)
    want = j_pipe(img, sk)
    for pipe in (dp, sharded):
        got = pipe(img, sk)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == np.uint8
            diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
            assert diff.max() <= 1, diff.max()
    assert np.abs(want[0].astype(int) - img).max() > 8    # an edit happened

    # the serving executor's buckets (1 and max_batch 3 here) need not
    # divide over the replicas: the pipeline pads them. A batch of 1 runs
    # alone on replica 0, as row 0 of a batch of 2 does: equal results.
    ex = BatchingExecutor(dp, max_batch=3, max_wait_ms=1)
    try:
        ex.warmup((32, 32), timeout=120)
        got = ex.submit(img[0], sk[0]).result(timeout=120)
    finally:
        ex.shutdown()
    pair = dp(img[:2], sk[:2])
    for g, w in zip(got, pair):
        np.testing.assert_array_equal(g, w[0])


def _train_batch(B, H, seed):
    rs = np.random.RandomState(seed)
    return {
        "image": rs.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
        "gt": rs.uniform(-1, 1, (B, H, H, 3)).astype(np.float32),
        "mask": (rs.rand(B, H, H, 1) > 0.9).astype(np.float32),
        "edgegt": (rs.rand(B, H, H, 1) > 0.9).astype(np.float32),
        "random_mask": (rs.rand(B, H, H, 1) > 0.7).astype(np.float32),
        "random_mask2": (rs.rand(B, H, H, 1) > 0.7).astype(np.float32),
    }


def test_two_rank_train_step_matches_the_jax_mesh_step(tmp_path):
    """Two gloo ranks on the CPU, each with one row of a global batch of 2
    at 32^2: after one train_loop step the ranks hold identical nets and u
    buffers and draw the same next flags; their averaged metrics and
    conv1 weights match the JAX step on a 2-device mesh with the same
    flags, and the single-process port step on the whole batch."""
    cfg = tr.TrainConfig(netg=DeepFillConfig(attention_impl="kernel"))
    state = port_state(cfg)
    # the flags every rank draws from a generator seeded as init_train_state
    # seeds it: the first for the step, three more after it
    rng = SimpleNamespace(flag_rng=torch.Generator().manual_seed(0))
    flags, *next_flags = (tr.draw_flags(rng, cfg) for _ in range(4))
    key = next(k for k in range(32) if tuple(
        int(jax.random.randint(kk, (), 0, 3))
        for kk in jax.random.split(jax.random.PRNGKey(k))) == flags)
    batch = _train_batch(2, 32, 0)
    np.savez(tmp_path / "batch.npz", **batch)

    ctx = multiprocessing.get_context("spawn")
    init_method = distributed.free_tcp_address()
    ranks = [ctx.Process(target=rank_step, args=(
        r, 2, init_method, str(tmp_path / "batch.npz"),
        str(tmp_path / f"rank{r}.npz"))) for r in range(2)]
    for p in ranks:
        p.start()
    for p in ranks:
        p.join(240)
    assert [p.exitcode for p in ranks] == [0, 0]
    r0, r1 = (dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2))
    assert r0.keys() == r1.keys()
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)

    # the JAX step on a two-device mesh, the same weights and flags
    jcfg = j_tr.TrainConfig(precision="highest")
    params = {label: state_dict_to_jax_params(net.state_dict())
              for label, net in state.nets.items()}
    opt_g, opt_d = j_tr.make_optimizers(jcfg)
    jstate = {"params": params,
              "opt_g": opt_g.init({"M": params["M"], "G": params["G"]}),
              "opt_d": opt_d.init(j_d.trainable(params["D"])),
              "step": jnp.zeros((), jnp.int32)}
    dmesh = data_parallel_mesh(2, jax.devices()[:2])
    jstate = jax.device_put(jstate, NamedSharding(dmesh, P()))
    jbatch = {k: jax.device_put(jnp.asarray(v),
                                NamedSharding(dmesh, P(BATCH_AXIS)))
              for k, v in batch.items()}
    with dmesh:
        j_state, j_metrics = jax.jit(partial(j_tr.train_step, cfg=jcfg))(
            jstate, jbatch, jax.random.PRNGKey(key))
    # and the port's single-process step on the whole batch
    _, metrics = tr.train_step(state, {k: torch.from_numpy(v)
                                       for k, v in batch.items()},
                               *flags, cfg)

    assert float(r0["metric.flag"]) == flags[0]
    for k, v in j_metrics.items():
        np.testing.assert_allclose(r0[f"metric.{k}"], float(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(r0[f"metric.{k}"], float(metrics[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for label in ("M", "G"):
        got = r0[f"{label}.conv1.weight"]
        single = state.nets[label].conv1.weight.detach().numpy()
        want = jax_params_to_state_dict(
            jax.device_get(j_state["params"][label]))["conv1.weight"]
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=label)
        np.testing.assert_allclose(got, single, rtol=1e-4, atol=1e-5,
                                   err_msg=label)
    np.testing.assert_array_equal(r0["next_flags"], next_flags)


def test_ranks_read_their_rows_of_the_global_batch(tmp_path):
    """A rank's loader (serial and thread paths) holds its rows of each
    global batch: the ranks' rows together are the batch a single process
    reads through the pool (items drawn from (seed, epoch, index))."""
    d = tmp_path / "imgs"
    d.mkdir()
    rs = np.random.RandomState(0)
    for i in range(6):
        arr = (rs.rand(36, 40, 3) * 255).astype(np.uint8)
        arr[9:18] = 255
        Image.fromarray(arr).save(d / f"{i}.png")
    opt = argparse.Namespace(
        train_image_dir=str(d), train_image_list=None,
        preprocess_mode="resize_and_crop", load_size=40, crop_size=32,
        aspect_ratio=1.0, isTrain=True, no_flip=False, canny_low=100,
        canny_high=200, decode_cache_mb=1, not_om=False, cjit=None,
        path_objectshape_list=None, path_objectshape_base=None,
        max_dataset_size=None, batchSize=4, serial_batches=False,
        dataset_mode="editimage", nThreads=0)
    whole = data.create_dataloader(opt)
    ds = whole.dataset
    epochs = []
    for epoch in (1, 2):
        whole._epoch = epoch         # as __iter__ sets it
        order = [list(idx) for idx in whole._index_batches()]
        data._worker_init(ds, whole.seed)
        epochs.append([whole._collate([data._worker_get((i, epoch))
                                       for i in idx]) for idx in order])
    data._WORKER_STATE.clear()
    assert len(epochs[0]) == 1             # 6 items, B = 4, drop_last
    for threads in (0, 1):
        opt.nThreads = threads
        loaders = [data.create_dataloader(opt, rank=r, world=2)
                   for r in range(2)]
        got = [[list(loader) for loader in loaders] for _ in range(2)]
        for epoch, want in enumerate(epochs):
            for b, w in enumerate(want):
                rows = [got[epoch][r][b] for r in range(2)]
                assert all(r["valid"] == 2 for r in rows)
                for k, v in w.items():
                    if isinstance(v, np.ndarray):
                        np.testing.assert_array_equal(
                            np.concatenate([r[k] for r in rows]), v,
                            err_msg=k)
                    elif k == "path":
                        assert rows[0][k] + rows[1][k] == v
    with pytest.raises(ValueError, match="divides over 3 ranks"):
        data.DataLoader(ds, 4, drop_last=True, rank=0, world=3)


def test_train_cli_on_two_ranks(tmp_path):
    """--data_parallel 2 --device cpu: rank 0 prints each step, writes each
    metrics row and the epoch's checkpoints once; a SIGTERM to the session's
    process group in epoch 2 stops both ranks after the same step, with
    exit 128 + 15 and train_state_latest.pt written."""
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rs = np.random.RandomState(0)
    for i in range(4):
        arr = (rs.rand(32, 32, 3) * 255).astype(np.uint8)
        arr[8:16] = 255
        Image.fromarray(arr).save(imgs / f"{i}.png")
    run = tmp_path / "ck" / "dp"
    proc = subprocess.Popen(
        [sys.executable, "-m", "sketchedit_tpu_torch.cli.train",
         "--name", "dp", "--checkpoints_dir", str(tmp_path / "ck"),
         "--dataset_mode", "editimage", "--train_image_dir", str(imgs),
         "--batchSize", "2", "--niter", "500", "--use_cam", "--pool_type",
         "max", "--joint_train_inp", "--not_om", "--preprocess_mode",
         "resize_and_crop", "--load_size", "32", "--crop_size", "32",
         "--no_flip", "--save_epoch_freq", "1", "--print_freq", "2",
         "--device", "cpu", "--data_parallel", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, start_new_session=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        deadline = time.time() + 240
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if line.startswith("epoch 2 iter 2 "):
                break
            assert time.time() < deadline and proc.poll() is None, seen[-20:]
        os.killpg(proc.pid, signal.SIGTERM)
        out = "".join(seen) + proc.stdout.read()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert rc == 128 + signal.SIGTERM, (rc, out[-3000:])
    assert "data-parallel over 2 ranks: cpu, cpu" in out
    assert out.count("checkpointed on signal 15; exiting") == 1
    assert out.count("saved the model at the end of epoch 1") == 1
    assert out.count("epoch 1 iter 2 ") == out.count("epoch 1 iter 4 ") == 1
    files = set(os.listdir(run))
    for label in "MGD":
        assert {f"1_net_{label}.npz", f"latest_net_{label}.npz"} <= files
    assert {"train_state_latest.pt", "iter.txt", "opt.json"} <= files
    with open(run / "metrics.jsonl") as f:
        rows = [(r["epoch"], r["iter"]) for r in map(json.loads, f)]
    assert len(rows) == len(set(rows)) >= 3 and rows[:2] == [(1, 2), (1, 4)]


def test_train_cli_refuses_ranks_that_do_not_divide_the_batch(
        tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "train", "--name", "r", "--checkpoints_dir", str(tmp_path),
        "--dataset_mode", "editimage", "--train_image_dir", str(tmp_path),
        "--batchSize", "2", "--device", "cpu", "--data_parallel", "3"])
    with pytest.raises(ValueError, match="does not divide over 3"):
        cli.main()
