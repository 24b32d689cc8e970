"""The plain reference on the CPU at 64^2: it runs, it agrees with the
program in float32, and it imports nothing of the program or of JAX."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest
import torch

from benchmark import inputs, manifest, weights
from benchmark.reference import edit, train
from benchmark.reference.precision import FP8
from benchmark.traffic import train_steps

ROOT = manifest.ROOT
GAINS = {"M": 1.8, "G": 1.5}


def _requests(seed, n=2, size=64):
    g = torch.Generator().manual_seed(seed)
    return (inputs.photo_like(g, n, size, "cpu"),
            inputs.strokes(g, n, size, "cpu"))


def test_reference_edit_runs_and_matches_the_port_in_float32():
    from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
    from sketchedit_tpu_torch.models.editline2 import (
        EditLine2, EditLine2Config, edit_u8)
    W = {n: weights.make(n, 5, "cpu", GAINS) for n in "MG"}
    img, sk = _requests(5)
    model = EditLine2(EditLine2Config(netg=DeepFillConfig(),
                                      compute_dtype="float32"))
    model.netM.load_state_dict(W["M"])
    model.netG.load_state_dict(W["G"])
    model.eval()
    with torch.inference_mode():
        comp, mask = edit_u8(model, img, sk)
    ref_comp, ref_mask, hard = edit.edit(W, img, sk)
    assert 0.05 < hard.mean() < 0.95          # neither empty nor full
    assert (comp.int() - ref_comp.int()).abs().max() <= 1
    assert (mask.int() - ref_mask.int()).abs().max() <= 1
    soft = edit.soft_mask(W, img, sk)
    assert (soft - mask.float()).abs().max() <= 0.5 + 1e-3
    forced = edit.composite(W, img, sk, hard, soft / 255.0)
    assert (forced - comp.float()).abs().max() <= 0.5 + 1e-3


def test_fp8_control_is_further_than_rounding():
    W = {n: weights.make(n, 6, "cpu", GAINS) for n in "MG"}
    img, sk = _requests(6)
    ref = edit.soft_mask(W, img, sk)
    low = edit.soft_mask(W, img, sk, FP8)
    assert (low - ref).pow(2).mean().sqrt() > 1.0


def _batch(seed, B=2, size=64):
    g = torch.Generator().manual_seed(seed)
    return {"image": inputs.photo_like(g, B, size, "cpu"),
            "mask": inputs.strokes(g, B, size, "cpu") > 0,
            "edgegt": inputs.strokes(g, B, size, "cpu", 12, 20) > 0,
            "random_mask": inputs.rectangles(g, B, size, "cpu"),
            "random_mask2": inputs.rectangles(g, B, size, "cpu")}


HP = {"lr": 2e-4, "beta1": 0.0, "beta2": 0.9, "lambda_vgg": 10.0,
      "lambda_l1": 1.0, "lambda_l1_mask": 1.0, "mask_threshold": 0.5}


def test_reference_train_step_runs_and_matches_the_port_in_float32():
    from sketchedit_tpu_torch.models.deepfill_c2 import (
        DeepFillC2Generator, DeepFillConfig)
    from sketchedit_tpu_torch.models.discriminator import Discriminator
    from sketchedit_tpu_torch.models.md_generator import MDGenerator
    from sketchedit_tpu_torch.train import trainer as tr
    W = {n: weights.make(n, 7, "cpu", GAINS) for n in "MGD"}
    vgg = weights.vgg(7, "cpu")
    batch = _batch(7)
    flags = [(1, 0), (0, 2)]
    ref = train.train_steps(W, vgg, [batch, _batch(8)], flags, HP)
    assert len(ref["losses"]) == 2 and all(v > 0 for v in ref["grad"].values())

    cfg = tr.TrainConfig(netg=DeepFillConfig(), no_vgg_loss=False,
                         compute_dtype="float32")
    nets = {"M": MDGenerator(), "G": DeepFillC2Generator(cfg.netg),
            "D": Discriminator()}
    for n, net in nets.items():
        net.load_state_dict(W[n])
    opt_g, opt_d = tr.make_optimizers(cfg, nets)
    state = tr.TrainState(nets=nets, opt_g=opt_g, opt_d=opt_d,
                          flag_rng=torch.Generator())
    leaves = {f"{n}.{k}": p for n, net in nets.items()
              for k, p in net.named_parameters()}
    prog = {"losses": [], "grad": {}}
    for i, (b, (fg, fd)) in enumerate(zip([batch, _batch(8)], flags)):
        _, m = tr.train_step(state, b, fg, fd, cfg, vgg_params=vgg)
        prog["losses"].append((m["G_total"].item(),
                               (m["D_Fake"] + m["D_real"]).item()))
        if i == 0:
            for k, p in leaves.items():
                opt = opt_d if k.startswith("D.") else opt_g
                prog["grad"][k] = opt.state[p]["exp_avg"].norm().item()
    prog["change"] = {k: (p.detach() - W[k[0]][k[2:]]).norm().item()
                      for k, p in leaves.items()}
    # the port may take its packed layers (another order of summation); a
    # hard-mask pixel that crosses 0.5 for it moves the second step a little
    prog["soft"] = ref["soft"]              # masks: the edit test's part
    got = train_steps._gaps(prog, ref, HP["mask_threshold"])
    assert got["loss_gap"] < 3e-3, got
    assert got["grad_gap"] < 1e-3, got
    assert got["change_gap"] < 3e-2, got


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    (ROOT / "benchmark" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_neither_the_program_nor_jax(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top in ("__future__", "contextlib", "torch", "benchmark"), name
        if top == "benchmark":
            assert name.startswith("benchmark.reference"), name


def test_a_run_loads_no_jax():
    """A whole run of a cell, on the CPU at 64^2 (the harness's look for a
    card skipped), leaves no module of JAX, Flax or the JAX package loaded:
    top-level names compared whole, so the port passes."""
    code = (
        "import json, sys\n"
        "from benchmark import run\n"
        "r = run.run_cell('celeb256.serve_c64', 3, 1.0, False, device='cpu',"
        " config_overrides={'resolution': 64}, workload_overrides={"
        "'clients': 2, 'max_batch': 2, 'pool': 4, 'sample': 2,"
        " 'check_block': 2})\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'bad': run.forbidden_modules(), 'tops': tops,"
        " 'correct': r['correct']}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert "sketchedit_tpu_torch" in got["tops"]
    assert not {"jax", "jaxlib", "flax", "sketchedit_tpu"} & set(got["tops"])
