"""``scripts/edit_eval_torch.py`` and ``scripts/mask_eval_torch.py`` against
``scripts/edit_eval.py`` and ``scripts/mask_eval.py`` on the same
checkpoint and images (three 40^2 PNGs, 32^2 crops, kaiming weights scaled
so that the soft mask is not flat): the same report keys, and every
per-item number within 1e-3 dB (PSNRs) or 1e-5 (the rest), float32 on the
CPU on both sides."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import jax

from sketchedit_tpu.models import editline2 as j_e
from sketchedit_tpu.params import checkpoint as j_ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import edit_eval_torch  # noqa: E402
import mask_eval_torch  # noqa: E402

ENV = {**os.environ, "JAX_PLATFORMS": "cpu",
       "SKETCHEDIT_CACHE_DIR": os.path.join(REPO, ".jax_cache")}
NET_FLAGS = ["--use_cam", "--joint_train_inp", "--pool_type", "max"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    imgs = root / "imgs"
    imgs.mkdir()
    rs = np.random.RandomState(0)
    for i in range(3):
        arr = (rs.rand(40, 40, 3) * 255).astype(np.uint8)
        arr[10:20] = 255                        # edges for Canny
        Image.fromarray(arr).save(imgs / f"{i}.png")
    params = j_e.init_params(jax.random.PRNGKey(3), init_type="kaiming")
    params = {net: {layer: {"w": np.asarray(p["w"]) * np.float32(gain),
                            "b": np.asarray(p["b"])}
                    for layer, p in params[net].items()}
              for net, gain in (("M", 1.8), ("G", 1.5))}
    j_ckpt.save_pipeline(params, "latest", argparse.Namespace(
        checkpoints_dir=str(root / "ck"), name="x"))
    return root


def _common(root):
    return ["--checkpoints_dir", str(root / "ck"), "--name", "x",
            "--image_dir", str(root / "imgs"), "--items", "3",
            "--load_size", "40", "--crop_size", "32"]


def _jax_report(script, args, report):
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script), *args,
         "--report", str(report)],
        capture_output=True, text=True, env=ENV, cwd=REPO, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    with open(report) as f:
        return json.load(f)


def _assert_rows_close(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            atol = 1e-3 if "psnr" in k else 1e-5
            assert abs(g[k] - w[k]) <= atol, (k, g[k], w[k])


@pytest.mark.parametrize("mode", [[], ["--oracle_mask", "--comparators",
                                       "all"]], ids=["end_to_end", "oracle"])
def test_edit_eval_torch_matches_jax(run_dir, tmp_path, mode):
    args = [*_common(run_dir), "--batch", "2", *NET_FLAGS, *mode]
    want = _jax_report("edit_eval.py", args, tmp_path / "j.json")
    report = tmp_path / "t.json"
    got = edit_eval_torch.main([*args, "--device", "cpu",
                                "--report", str(report)])
    with open(report) as f:
        assert json.load(f) == json.loads(json.dumps(got))
    assert got.keys() == want.keys()
    assert (got["mode"], got["items"]) == (want["mode"], want["items"])
    _assert_rows_close(got["per_item"], want["per_item"])
    _assert_rows_close([got["mean"]], [want["mean"]])
    if mode:
        assert got["comparators"].keys() == want["comparators"].keys()
        for c, w in want["comparators"].items():
            _assert_rows_close(got["comparators"][c]["per_item"],
                               w["per_item"])
        assert all(r["outside_l1"] == 0.0 for r in got["per_item"])
    else:
        assert 0.0 < got["mean"]["soft_mass"] < 1.0


def test_mask_eval_torch_matches_jax(run_dir, tmp_path):
    args = _common(run_dir)
    want = _jax_report("mask_eval.py", args, tmp_path / "j.json")
    got = mask_eval_torch.main([*args, "--device", "cpu"])
    assert got.keys() == want.keys() and got["items"] == 3
    _assert_rows_close(got["per_item"], want["per_item"])
    assert 0.0 < got["mean"]["iou_0.5"] < 1.0
    with pytest.raises(SystemExit, match="no netM checkpoint"):
        mask_eval_torch.main([*args[:2], "--name", "absent", *args[4:],
                              "--device", "cpu"])
