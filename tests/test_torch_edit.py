"""The port's single-edit path as a whole against the JAX package's, on the
CPU: ``edit_u8`` and ``generate`` on the same weights and inputs, plus the
checkpoint formats, the runner and the batch CLI.

Weights: the JAX package's kaiming init scaled by 1.8 (netM) and 1.5
(netG), for the reason test_torch_models.py gives. Tolerances: uint8
within 1 LSB (a rounding boundary may fall between the two float32
results); soft masks atol 1e-4; hard masks equal. Each case's seed was
picked so that no padded soft-mask pixel lies within 1e-4 of the 0.5
threshold, and the test asserts that margin, so a threshold flip cannot
pass as noise.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sketchedit_tpu.models import editline2 as j_e
from sketchedit_tpu_torch.models import editline2 as t_e
from sketchedit_tpu_torch.models.editline2 import EditLine2
from sketchedit_tpu_torch.options import parse_argv
from sketchedit_tpu_torch.options.test_options import TestOptions as InferOptions
from sketchedit_tpu_torch.params.checkpoint import load_network_path
from sketchedit_tpu_torch.params.convert import jax_params_to_state_dict
from sketchedit_tpu_torch.runner import build_pipeline

GAIN_M, GAIN_G = 1.8, 1.5
MARGIN = 1e-4
# (H, W, seed): 64^2; 60x76, which pads to 64x80; 12x20, which the 16 px
# floor pads to 16x24
CASES = [(64, 64, 4), (60, 76, 0), (12, 20, 8)]


def jax_params(seed):
    """{'M': ..., 'G': ...} numpy params in the JAX layout."""
    params = j_e.init_params(jax.random.PRNGKey(seed), init_type="kaiming")
    return {net: {layer: {"w": np.asarray(p["w"]) * np.float32(gain),
                          "b": np.asarray(p["b"])}
                  for layer, p in params[net].items()}
            for net, gain in (("M", GAIN_M), ("G", GAIN_G))}


def port_model(params):
    model = EditLine2()
    model.netM.load_state_dict(jax_params_to_state_dict(params["M"]),
                               strict=True)
    model.netG.load_state_dict(jax_params_to_state_dict(params["G"]),
                               strict=True)
    return model.eval()


def u8_inputs(seed, H, W, B=1):
    rs = np.random.RandomState(seed)
    img = rs.randint(0, 256, (B, H, W, 3)).astype(np.uint8)
    sketch = ((rs.rand(B, H, W, 1) > 0.9) * 255).astype(np.uint8)
    return img, sketch


def assert_within_1lsb(got, want):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, f"max uint8 difference {diff.max()}"


@pytest.mark.parametrize("H,W,seed", CASES)
def test_edit_u8_matches_jax(H, W, seed):
    params = jax_params(seed)
    img, sketch = u8_inputs(seed, H, W)
    want_c, want_m = j_e.edit_u8(params, jnp.asarray(img), jnp.asarray(sketch))
    model = port_model(params)
    with torch.no_grad():
        got_c, got_m = t_e.edit_u8(model, torch.from_numpy(img),
                                   torch.from_numpy(sketch))
    assert got_c.shape == (1, H, W, 3) and got_m.shape == (1, H, W, 1)
    assert got_c.dtype == torch.uint8
    assert_within_1lsb(got_c.numpy(), np.asarray(want_c))
    assert_within_1lsb(got_m.numpy(), np.asarray(want_m))
    # the edit is not vacuous: the hole gets content unlike the input
    assert np.abs(np.asarray(want_c).astype(int) - img).mean() > 5


@pytest.mark.parametrize("H,W,seed", CASES)
def test_generate_masks_match_jax(H, W, seed):
    """Soft masks within 1e-4 and hard masks equal, on the padded grid
    that netG sees."""
    params = jax_params(seed)
    img, sketch = u8_inputs(seed, H, W)
    image = img.astype(np.float32) / 127.5 - 1.0
    strokes = (sketch > 0).astype(np.float32)
    jimg, jsk, _ = j_e.pad_to_grid(jnp.asarray(image), jnp.asarray(strokes))
    want = j_e.generate(params, jimg, jsk)
    want_soft = np.asarray(want["mask"])
    assert np.abs(want_soft - 0.5).min() > MARGIN
    assert 0.05 < (want_soft > 0.5).mean() < 0.95

    timg, tsk, hw = t_e.pad_to_grid(torch.from_numpy(image).permute(0, 3, 1, 2),
                                    torch.from_numpy(strokes).permute(0, 3, 1, 2))
    assert hw == (H, W)
    with torch.no_grad():
        got = t_e.generate(port_model(params), timg, tsk)
    got_soft = got["mask"].permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got_soft, want_soft, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got["mask_inpaint"].permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want["mask_inpaint"]))
    np.testing.assert_allclose(got["fake"].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want["fake"]), rtol=0, atol=1e-4)


def _opt(tmp_path, *extra):
    return parse_argv(InferOptions, [
        "--name", "ck", "--checkpoints_dir", str(tmp_path), "--device", "cpu",
        "--use_cam", "--pool_type", "max", "--joint_train_inp", *extra])


def _write_npz(params, directory):
    os.makedirs(directory, exist_ok=True)
    for net in ("M", "G"):
        flat = {f"{layer}/{leaf}": v for layer, p in params[net].items()
                for leaf, v in p.items()}
        np.savez(os.path.join(directory, f"latest_net_{net}.npz"), **flat)


def test_pipeline_from_npz_matches_jax(tmp_path):
    """JAX-layout .npz checkpoints -> runner -> uint8 edit, against JAX."""
    H, W, seed = CASES[0]     # a case whose threshold margin is asserted
    params = jax_params(seed)
    _write_npz(params, tmp_path / "ck")
    pipeline = build_pipeline(_opt(tmp_path), require_checkpoint=True)
    img, sketch = u8_inputs(seed, H, W)
    got_c, got_m = pipeline(img, sketch)
    want_c, want_m = j_e.edit_u8(params, jnp.asarray(img), jnp.asarray(sketch))
    assert got_c.dtype == np.uint8 and got_c.shape == (1, H, W, 3)
    assert_within_1lsb(got_c, np.asarray(want_c))
    assert_within_1lsb(got_m, np.asarray(want_m))


def test_pth_with_module_prefix_loads(tmp_path):
    """Reference .pth state dicts, keys prefixed with 'module.', load
    strictly through the runner and give the same weights."""
    params = jax_params(3)
    directory = tmp_path / "ck"
    directory.mkdir()
    states = {}
    for net in ("M", "G"):
        states[net] = jax_params_to_state_dict(params[net])
        torch.save({f"module.{k}": v for k, v in states[net].items()},
                   directory / f"latest_net_{net}.pth")
    loaded = load_network_path(str(directory / "latest_net_G.pth"))
    assert loaded.keys() == states["G"].keys()
    pipeline = build_pipeline(_opt(tmp_path), require_checkpoint=True)
    for net in ("M", "G"):
        got = getattr(pipeline.model, f"net{net}").state_dict()
        for k, v in states[net].items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)


def test_missing_checkpoint_fresh_init_is_seeded(tmp_path, capsys):
    opt = _opt(tmp_path, "--init_type", "kaiming")
    a = build_pipeline(opt, seed=5)
    assert "WARNING" in capsys.readouterr().out
    b = build_pipeline(opt, seed=5)
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    with pytest.raises(FileNotFoundError):
        build_pipeline(opt, require_checkpoint=True)


def test_entry_points_raise_without_gpu(tmp_path, monkeypatch):
    """No GPU and no request for the CPU: raise, never run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = parse_argv(InferOptions, ["--checkpoints_dir", str(tmp_path)])
    assert opt.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pipeline(opt)


def test_bfloat16_pipeline_runs(tmp_path):
    pipeline = build_pipeline(_opt(tmp_path, "--compute_dtype", "bfloat16",
                                   "--init_type", "kaiming"))
    assert pipeline.model.netG.conv1.weight.dtype == torch.bfloat16
    img, sketch = u8_inputs(1, 20, 28)
    composed, mask = pipeline(img, sketch)
    assert composed.shape == (1, 20, 28, 3) and mask.shape == (1, 20, 28, 1)


def test_cli_writes_pngs(tmp_path, monkeypatch):
    from PIL import Image
    from sketchedit_tpu_torch.cli import infer

    rs = np.random.RandomState(0)
    for d in ("images", "edges"):
        (tmp_path / d).mkdir()
    names = ["a", "b", "c"]
    for n in names:
        Image.fromarray(rs.randint(0, 256, (32, 32, 3)).astype(np.uint8)).save(
            tmp_path / "images" / f"{n}.png")
        Image.fromarray(((rs.rand(32, 32) > 0.9) * 255).astype(np.uint8)).save(
            tmp_path / "edges" / f"{n}.png")
    (tmp_path / "list.txt").write_text("".join(f"{n}.png\n" for n in names))
    out, masks = tmp_path / "out", tmp_path / "masks"
    monkeypatch.setattr(sys, "argv", [
        "infer", "--batchSize", "2", "--name", "celeb", "--joint_train_inp",
        "--dataset_mode", "testimage", "--image_dirs", str(tmp_path / "images"),
        "--mask_dirs", str(tmp_path / "edges"),
        "--image_lists", str(tmp_path / "list.txt"), "--image_postfix", ".png",
        "--mask_postfix", ".png", "--pool_type", "max", "--use_cam",
        "--output_dir", str(out), "--output_mask_dir", str(masks),
        "--checkpoints_dir", str(tmp_path / "ck"), "--device", "cpu"])
    infer.main()
    for n in names:
        assert np.asarray(Image.open(out / f"{n}.png")).shape == (32, 32, 3)
        assert np.asarray(Image.open(masks / f"{n}.png")).shape == (32, 32)
