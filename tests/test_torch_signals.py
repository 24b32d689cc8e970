"""Stop signals and the loader's spawned workers: a worker ignores SIGINT
and SIGTERM, so a signal sent to the trainer's whole process group (Ctrl-C
in a terminal, a scheduler's SIGTERM) leaves the pool running, and the
train CLI's handler alone decides to checkpoint after the step in flight
and exit with 128 + the signal. One forced spawn pool of 2 workers, 32^2
PNGs."""

import argparse
import os
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest
from PIL import Image

from sketchedit_tpu_torch import data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pngs(directory, n):
    directory.mkdir()
    rs = np.random.RandomState(0)
    for i in range(n):
        arr = (rs.rand(32, 32, 3) * 255).astype(np.uint8)
        arr[8:16] = 255
        Image.fromarray(arr).save(directory / f"{i}.png")
    return directory


def test_pool_workers_survive_sigint_and_sigterm(tmp_path, monkeypatch):
    """An epoch whose workers get SIGINT and then SIGTERM after its first
    batch (from another process, as a terminal or a scheduler sends them)
    ends with the same batches as the same epoch undisturbed. A worker that
    dies all the same (SIGKILL) breaks the pool, which then raises in the
    caller, and the pool's own SIGTERM still ends the other worker."""
    monkeypatch.setenv("SKETCHEDIT_FORCE_PROCESS_WORKERS", "1")
    opt = argparse.Namespace(
        train_image_dir=str(_pngs(tmp_path / "imgs", 8)),
        train_image_list=None, preprocess_mode="resize_and_crop",
        load_size=32, crop_size=32, aspect_ratio=1.0, isTrain=True,
        no_flip=False, canny_low=100, canny_high=200, decode_cache_mb=1,
        not_om=True, cjit=None, max_dataset_size=None, batchSize=2,
        serial_batches=False, dataset_mode="editimage", nThreads=2)
    loader = data.create_dataloader(opt)
    assert loader.mode == "processes"
    try:
        want = list(loader)
        loader._epoch = 0                 # the same epoch again
        it = iter(loader)
        got = [next(it)]
        workers = list(loader._pool._processes)
        assert len(workers) == 2
        for sig in ("INT", "TERM"):      # from another process than ours
            subprocess.run(["kill", "-s", sig, *map(str, workers)],
                           check=True)
            time.sleep(0.2)
        got += list(it)
        assert sorted(loader._pool._processes) == sorted(workers)

        os.kill(workers[0], signal.SIGKILL)
        deadline = time.time() + 30
        while not loader._pool._broken:
            assert time.time() < deadline
            time.sleep(0.05)
        with pytest.raises(BrokenProcessPool):
            list(loader)
    finally:
        closing = threading.Thread(target=loader.close)
        closing.start()
        closing.join(60)
    assert not closing.is_alive(), "close() hangs on a broken pool"
    assert not any(os.path.exists(f"/proc/{pid}") for pid in workers)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


def test_cli_group_sigint_with_a_worker_pool(tmp_path):
    """The train CLI with --nThreads 2 (the forced spawn pool), run in a
    session of its own, gets SIGINT as a group after two steps: it exits
    with 128 + 2 and has written train_state_latest.pt. (A group SIGTERM
    is sent to two ranks in test_torch_parallel.py.)"""
    signum = int(signal.SIGINT)
    imgs = _pngs(tmp_path / "imgs", 4)
    ck = tmp_path / "ck"
    proc = subprocess.Popen(
        [sys.executable, "-m", "sketchedit_tpu_torch.cli.train",
         "--name", "sig", "--checkpoints_dir", str(ck),
         "--dataset_mode", "editimage", "--train_image_dir", str(imgs),
         "--batchSize", "2", "--niter", "500", "--use_cam", "--pool_type",
         "max", "--joint_train_inp", "--not_om", "--preprocess_mode",
         "resize_and_crop", "--load_size", "32", "--crop_size", "32",
         "--no_flip", "--save_epoch_freq", "1000", "--print_freq", "2",
         "--nThreads", "2", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, start_new_session=True,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "SKETCHEDIT_FORCE_PROCESS_WORKERS": "1"})
    try:
        deadline = time.time() + 240
        seen = []
        for line in proc.stdout:
            seen.append(line)
            if "ms/img" in line:
                break
            assert time.time() < deadline and proc.poll() is None, seen[-20:]
        assert "loader: processes, nThreads 2\n" in seen, seen[-20:]
        os.killpg(proc.pid, signum)
        out = proc.stdout.read()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert rc == 128 + signum, (rc, out[-3000:])
    assert f"checkpointed on signal {signum}; exiting" in out
    assert "BrokenProcessPool" not in out and "Traceback" not in out
    files = set(os.listdir(ck / "sig"))
    assert {"latest_net_M.npz", "latest_net_G.npz", "latest_net_D.npz",
            "train_state_latest.pt", "iter.txt"} <= files
