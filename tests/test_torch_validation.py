"""The port's held-out validation and metrics log
(``sketchedit_tpu_torch/train/validation.py``) against the JAX package's.

``Validator.run`` is held to the JAX ``Validator.run`` on the same params
(converted with ``params/convert.jax_params_to_state_dict``) and the same
held-out PNGs, float32 and highest precision on both sides: psnr and
region_psnr within 1e-3 dB, ssim and the L1s within 1e-5, mask_iou equal
but for hard-mask pixels whose soft mask lies within 1e-4 of 0.5."""

import argparse
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from sketchedit_tpu.models import editline2 as j_e
from sketchedit_tpu.options import parse_argv as j_parse_argv
from sketchedit_tpu.options.train_options import TrainOptions as JTrainOptions
from sketchedit_tpu.train import trainer as j_tr
from sketchedit_tpu.train import validation as j_val
from sketchedit_tpu_torch.models import editline2 as t_e
from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillC2Generator
from sketchedit_tpu_torch.models.md_generator import MDGenerator
from sketchedit_tpu_torch.options import parse_argv as t_parse_argv
from sketchedit_tpu_torch.options.train_options import (
    TrainOptions as TTrainOptions)
from sketchedit_tpu_torch.params.convert import jax_params_to_state_dict
from sketchedit_tpu_torch.train import trainer as t_tr
from sketchedit_tpu_torch.train import validation as t_val

GAIN_M, GAIN_G = 1.8, 1.5
FLIP_MARGIN = 1e-4
METRICS = ("psnr", "ssim", "region_psnr", "region_l1", "outside_l1",
           "mask_iou")


def _argv(tmp_path, hw=48, n=3):
    imgs = tmp_path / "val_imgs"
    if not imgs.exists():
        imgs.mkdir()
        rs = np.random.RandomState(0)
        for i in range(n):
            arr = (rs.rand(hw, hw, 3) * 255).astype(np.uint8)
            arr[hw // 4:hw // 2] = 255              # edges for Canny
            Image.fromarray(arr).save(imgs / f"{i}.png")
    return ["--name", "v", "--checkpoints_dir", str(tmp_path / "ck"),
            "--dataset_mode", "editimage", "--train_image_dir", str(imgs),
            "--val_image_dir", str(imgs), "--val_items", "2",
            "--batchSize", "2", "--preprocess_mode", "resize_and_crop",
            "--load_size", str(hw), "--crop_size", str(hw), "--not_om",
            "--no_flip", "--device", "cpu"]


def _jax_opt(argv):
    return j_parse_argv(JTrainOptions, [a for a in argv if a not in
                                        ("--device", "cpu")], save=False)


def _params(seed=3):
    """{'M', 'G'} numpy params in the JAX layout, kaiming scaled so that
    the soft mask is not flat at 0.5."""
    params = j_e.init_params(jax.random.PRNGKey(seed), init_type="kaiming")
    return {net: {layer: {"w": np.asarray(p["w"]) * np.float32(gain),
                          "b": np.asarray(p["b"])}
                  for layer, p in params[net].items()}
            for net, gain in (("M", GAIN_M), ("G", GAIN_G))}


def _port_nets(params):
    nets = {"M": MDGenerator(), "G": DeepFillC2Generator()}
    for k, net in nets.items():
        net.load_state_dict(jax_params_to_state_dict(params[k]), strict=True)
    return nets


def test_validator_matches_jax(tmp_path):
    argv = _argv(tmp_path)
    t_opt = t_parse_argv(TTrainOptions, argv, save=False)
    j_opt = _jax_opt(argv)
    t_v = t_val.build_validator(t_opt, t_tr.TrainConfig(precision="highest"))
    j_v = j_val.build_validator(j_opt, j_tr.TrainConfig(precision="highest"))
    # the same held-out batch, bit for bit
    for k in ("image", "sketch", "region"):
        np.testing.assert_array_equal(getattr(t_v, k), getattr(j_v, k), k)
    assert t_v.image.shape == (2, 48, 48, 3)
    assert t_v.region.any() and t_v.sketch.any()

    params = _params()
    nets = _port_nets(params)
    for net in nets.values():
        net.train()
    got = t_v.run(nets)
    assert all(net.training for net in nets.values())   # modes restored
    want = j_v.run(jax.tree_util.tree_map(jnp.asarray, params))
    assert set(got) == set(want) == set(METRICS)
    for k in ("psnr", "region_psnr"):
        assert abs(got[k] - want[k]) <= 1e-3, (k, got[k], want[k])
    for k in ("ssim", "region_l1", "outside_l1"):
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])

    # mask_iou: any difference comes from pixels on the 0.5 threshold
    with torch.no_grad():
        model = t_e.EditLine2()
        model.netM.load_state_dict(nets["M"].state_dict())
        model.netG.load_state_dict(nets["G"].state_dict())
        _, t_soft = t_e.edit(model.eval(), torch.from_numpy(t_v.image),
                             torch.from_numpy(t_v.sketch))
    _, j_soft = j_e.edit(jax.tree_util.tree_map(jnp.asarray, params),
                         jnp.asarray(j_v.image), jnp.asarray(j_v.sketch),
                         config=j_v.config)
    t_soft, j_soft = t_soft.numpy(), np.asarray(j_soft)
    np.testing.assert_allclose(t_soft, j_soft, rtol=0, atol=1e-4)
    t_hard, j_hard = t_soft > 0.5, j_soft > 0.5
    flipped = t_hard != j_hard
    assert (np.abs(j_soft[flipped] - 0.5) < FLIP_MARGIN).all()
    region = t_v.region > 0.5

    def iou(hard):
        inter = (hard & region).sum(axis=(1, 2, 3))
        union = np.maximum((hard | region).sum(axis=(1, 2, 3)), 1)
        return float(np.mean(inter / union))

    assert 0.0 < iou(t_hard) < 1.0                # not a vacuous mask
    assert got["mask_iou"] == pytest.approx(iou(t_hard), abs=1e-6)
    assert want["mask_iou"] == pytest.approx(iou(j_hard), abs=1e-6)
    if not flipped.any():
        assert got["mask_iou"] == pytest.approx(want["mask_iou"], abs=1e-6)


def test_validator_is_float32_and_deterministic(tmp_path):
    """A bfloat16 train config still validates in float32; two calls and a
    rebuilt validator give the same numbers."""
    opt = t_parse_argv(TTrainOptions, _argv(tmp_path, hw=32), save=False)
    nets = _port_nets(_params(seed=5))
    f32 = t_val.Validator(opt, t_tr.TrainConfig(), opt.val_image_dir,
                          items=2)
    bf16 = t_val.Validator(opt, t_tr.TrainConfig(compute_dtype="bfloat16"),
                           opt.val_image_dir, items=2)
    assert bf16.config.compute_dtype == "float32"
    a, b, c = f32.run(nets), f32.run(nets), bf16.run(nets)
    assert a == b == c
    assert all(np.isfinite(a[k]) for k in METRICS)
    assert -1.0 <= a["ssim"] <= 1.0 and 0.0 <= a["mask_iou"] <= 1.0
    np.testing.assert_array_equal(f32.image, bf16.image)
    # items are capped at the dataset's size
    assert t_val.Validator(opt, t_tr.TrainConfig(), opt.val_image_dir,
                           items=50).image.shape[0] == 3


def test_build_validator_off_without_flag(tmp_path):
    opt = t_parse_argv(TTrainOptions, _argv(tmp_path, hw=32), save=False)
    opt.val_image_dir = ""
    assert t_val.build_validator(opt, t_tr.TrainConfig()) is None
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no images"):
        t_val.Validator(opt, t_tr.TrainConfig(), str(empty))


@pytest.mark.parametrize("metric,value,best,want", [
    ("psnr", 10.0, None, True), ("psnr", 11.0, 10.0, True),
    ("psnr", 9.0, 10.0, False), ("region_l1", 0.1, 0.2, True),
    ("region_l1", 0.3, 0.2, False), ("mask_iou", 0.5, 0.5, False)])
def test_is_improvement_matches_jax(metric, value, best, want):
    assert t_val.is_improvement(metric, value, best) is want
    assert j_val.is_improvement(metric, value, best) is want
    assert t_val.HIGHER_IS_BETTER == j_val.HIGHER_IS_BETTER


def test_recover_best_skips_a_torn_line(tmp_path):
    p = tmp_path / "metrics.jsonl"
    with open(p, "w") as f:
        f.write('{"kind": "train", "losses": {}}\n')
        f.write('{"kind": "val", "epoch": 1, "psnr": 18.0, "region_l1": 0.3}\n')
        f.write('{"kind": "val", "epoch": 2, "psnr": 21.5, "region_l1": 0.2}\n')
        f.write('{"kind": "val", "epoch": 3, "psnr": 20.0, "region_l1": NaN}\n')
        f.write('{"kind": "val", "epoch": 4, "psnr"')   # torn tail line
    for metric, want in (("psnr", 21.5), ("region_l1", 0.2),
                         ("mask_iou", None)):
        assert t_val.recover_best(str(p), metric) == want
        assert j_val.recover_best(str(p), metric) == want
    assert t_val.recover_best(str(tmp_path / "absent.jsonl"), "psnr") is None


def test_metrics_log_modes(tmp_path):
    base = dict(checkpoints_dir=str(tmp_path / "ck"), name="run")
    assert t_val.MetricsLog.from_opt(
        argparse.Namespace(metrics_log="off", **base)) is None
    auto = t_val.MetricsLog.from_opt(
        argparse.Namespace(metrics_log="auto", **base))
    assert auto.path == os.path.join(tmp_path, "ck", "run", "metrics.jsonl")
    auto.log({"kind": "train", "loss": 1.5})
    auto.log({"kind": "val", "psnr": float("nan")})   # must not raise
    # each line is on disk as soon as it is written
    rows = [json.loads(line) for line in open(auto.path)]
    assert rows[0] == {"kind": "train", "loss": 1.5}
    assert np.isnan(rows[1]["psnr"])
    auto.close()
    explicit = t_val.MetricsLog.from_opt(argparse.Namespace(
        metrics_log=str(tmp_path / "m.jsonl"), **base))
    explicit.log({"a": 1})
    explicit.close()
    assert json.loads(open(tmp_path / "m.jsonl").read()) == {"a": 1}


@pytest.mark.parametrize("track,lam,want", [
    ("auto", 0.0, "psnr"), ("auto", 1.0, "mask_iou"),
    ("ssim", 1.0, "ssim")])
def test_resolve_val_track(track, lam, want):
    ns = argparse.Namespace(val_track=track, lambda_mask_rec=lam)
    assert t_val.resolve_val_track(ns) == want == j_val.resolve_val_track(ns)
