"""scripts/convergence_check_torch.py on the CPU: three steps at 32^2,
B = 2, through the kernel route (on the CPU the ops' plain versions inside
the autograd Function) and the dense route, checking the printout and the
JSON line; the batch against the JAX script's.

Both routes compute the same losses on the same weights and batch (float32,
summation order only: rtol 1e-5). Three steps cannot converge, so both runs
end FAILED with exit code 1; on the card chip_smoke.py's ``convergence``
phase runs the script for 900 steps and requires CONVERGES.
"""

import contextlib
import importlib.util
import io
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = importlib.util.spec_from_file_location(
    "convergence_check_torch",
    os.path.join(REPO, "scripts", "convergence_check_torch.py"))
script = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(script)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the test runner puts several test files side
    by side on the host's cores, and the nets run at 32^2."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs():
    """impl -> (exit code, printed lines, the JSON line) of a 3-step run."""
    out = {}
    for impl in ("kernel", "dense"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = script.main(["--steps", "3", "--size", "32", "--batch", "2",
                              "--device", "cpu", "--dtype", "float32",
                              "--attention_impl", impl])
        lines = buf.getvalue().strip().splitlines()
        out[impl] = rc, lines, json.loads(lines[-1])
    return out


@pytest.mark.parametrize("impl", ["kernel", "dense"])
def test_three_steps_print_the_jax_scripts_lines(runs, impl):
    rc, out, res = runs[impl]
    # step 0 and the last step, then the verdict and the JSON line
    assert [ln.split(" ", 1)[0] for ln in out[:2]] == ["0", "2"]
    assert out[-2].startswith("FAILED: L1c ")
    assert rc == 1 and res["converges"] is False
    assert res["steps"] == 3 and res["attention_impl"] == impl
    assert res["dtype"] == "float32" and res["device"] == "cpu"
    assert res["card"] is None and res["ms_per_step"] > 0
    for key in ("first", "last"):
        assert set(res[key]) == set(script.LOSSES)
        assert all(np.isfinite(v) for v in res[key].values())
    assert res["ratios"]["L1c"] == pytest.approx(
        res["last"]["L1c"] / res["first"]["L1c"])
    # on the CPU no kernel launches
    assert set(res["launches"].values()) == {0}


def test_both_routes_compute_the_same_losses(runs):
    kernel, dense = runs["kernel"][2], runs["dense"][2]
    for key in ("first", "last"):
        for loss, v in kernel[key].items():
            assert v == pytest.approx(dense[key][loss], rel=1e-5, abs=1e-4)


def test_batch_is_the_jax_scripts(monkeypatch):
    """The image the script overfits is the JAX script's (RandomState(0),
    uniform in [-1, 1], drawn first), so the first L1 terms start where the
    JAX script's do."""
    seen = {}

    def capture(batch, device):
        seen.update(batch)
        return real(batch, device)

    from sketchedit_tpu_torch.train import trainer
    real = trainer.batch_to_device
    monkeypatch.setattr(trainer, "batch_to_device", capture)
    script.main(["--steps", "1", "--size", "16", "--batch", "2",
                 "--device", "cpu", "--dtype", "float32"])
    rs = np.random.RandomState(0)
    img = rs.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(seen["image"], img)
    assert seen["gt"] is seen["image"]
    np.testing.assert_array_equal(
        seen["mask"], (rs.rand(2, 16, 16, 1) > 0.95).astype(np.float32))


def test_the_port_takes_the_jax_steps():
    """Eight steps of the script's overfit at 32^2, B = 2, float32, from the
    port's initial weights converted to the JAX layout, with the flags the
    JAX script's step keys draw (fold_in(PRNGKey(1), i)): the port's L1c
    and L1f, the terms the script's gate reads, follow JAX's train_step.
    They part slowly: Adam's first steps move a weight by ±lr by the sign
    of its gradient, and the sign of a noise-level gradient may differ
    (tests/test_torch_train.py), so the bound is rtol 1e-3. The terms that
    read D's logits (G_total, D_Fake, D_real) move with D's own sign noise
    at twice the learning rate and are not compared here."""
    import jax
    import jax.numpy as jnp
    import torch

    from sketchedit_tpu.models import discriminator as j_d
    from sketchedit_tpu.train import trainer as j_tr
    from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
    from sketchedit_tpu_torch.params.convert import state_dict_to_jax_params
    from sketchedit_tpu_torch.train import trainer as tr

    cfg = tr.TrainConfig(netg=DeepFillConfig(attention_impl="kernel"),
                         lr=1e-3)
    jcfg = j_tr.TrainConfig(precision="highest", lr=1e-3)
    state = tr.init_train_state(cfg, seed=0, device="cpu")
    params = jax.tree_util.tree_map(jnp.asarray, {
        label: state_dict_to_jax_params(net.state_dict())
        for label, net in state.nets.items()})
    opt_g, opt_d = j_tr.make_optimizers(jcfg)
    jstate = {"params": params,
              "opt_g": opt_g.init({"M": params["M"], "G": params["G"]}),
              "opt_d": opt_d.init(j_d.trainable(params["D"])),
              "step": jnp.zeros((), jnp.int32)}
    B, S = 2, 32
    rs = np.random.RandomState(0)
    img = rs.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    batch = {"image": img, "gt": img}
    for k, p in (("mask", 0.95), ("edgegt", 0.95), ("random_mask", 0.7),
                 ("random_mask2", 0.7)):
        batch[k] = (rs.rand(B, S, S, 1) > p).astype(np.float32)
    jstep = jax.jit(lambda st, b, key: j_tr.train_step(st, b, key, jcfg))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(1)
    for i in range(8):
        k = jax.random.fold_in(key, i)
        kg, kd = jax.random.split(k)
        flags = [int(jax.random.randint(x, (), 0, 3)) for x in (kg, kd)]
        jstate, want = jstep(jstate, jbatch, k)
        state, got = tr.train_step(state, tbatch, *flags, cfg)
        for name in ("L1c", "L1f"):
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-3, atol=1e-6,
                                       err_msg=f"step {i} {name}")
