"""netM and netG of the port against the JAX nets at 64^2, on the CPU.

Weights come from the JAX package's kaiming init (its default xavier gain
of 0.02 would make the compare vacuous through underflow), scaled by 1.7
(netM) and 1.5 (netG): kaiming alone assumes ReLU, and the gated
activations shrink the signal until every output sits within 1e-3 of its
midpoint. They reach the port through ``jax_params_to_state_dict`` and load
strictly, which also checks the layer names. Tolerance atol 1e-4 on the tanh/sigmoid outputs:
float32 on both sides through ~50 convs, JAX at Precision.HIGHEST.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sketchedit_tpu.models import deepfill_c2 as j_g
from sketchedit_tpu.models import md_generator as j_m
from sketchedit_tpu_torch.models.deepfill_c2 import (
    DeepFillC2Generator, DeepFillConfig)
from sketchedit_tpu_torch.models.md_generator import MDGenerator
from sketchedit_tpu_torch.params.convert import jax_params_to_state_dict

HIGH = jax.lax.Precision.HIGHEST
ATOL = 1e-4


def nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


GAIN_M, GAIN_G = 1.7, 1.5


def scaled_params(init_params, seed, gain):
    """Kaiming params of one JAX net, every weight scaled by ``gain``."""
    params = init_params(jax.random.PRNGKey(seed), init_type="kaiming")
    return {layer: {"w": np.asarray(p["w"]) * np.float32(gain),
                    "b": np.asarray(p["b"])} for layer, p in params.items()}


def _inputs(seed, B=1, H=64, W=64):
    rs = np.random.RandomState(seed)
    img = rs.uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    sketch = (rs.rand(B, H, W, 1) > 0.9).astype(np.float32)
    mask = np.zeros((B, H, W, 1), np.float32)
    mask[:, H // 4:3 * H // 4, W // 4:3 * W // 4] = 1.0
    return img, sketch, mask


def test_md_generator_matches_jax():
    params = scaled_params(j_m.init_params, 0, GAIN_M)
    img, sketch, _ = _inputs(0)
    want_mask, want_img = j_m.apply(params, jnp.asarray(img),
                                    jnp.asarray(sketch), precision=HIGH)
    net = MDGenerator()
    net.load_state_dict(jax_params_to_state_dict(params),
                        strict=True)
    with torch.no_grad():
        got_mask, got_img = net(nchw(img), nchw(sketch))
    np.testing.assert_allclose(nhwc(got_mask), np.asarray(want_mask),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(nhwc(got_img), np.asarray(want_img),
                               rtol=0, atol=ATOL)
    assert np.asarray(want_mask).std() > 0.1    # not a vacuous compare


def test_md_generator_mask_dtype_widens_the_sigmoid():
    """mask_dtype=float32 under bfloat16 compute (the trainer's call, as
    md_generator.apply's mask_dtype in the JAX package): the soft mask is
    float32, rounds to the bf16 mask, and lies strictly inside (0, 1) at
    positions where the bf16 sigmoid is exactly 0 or 1. The last mask
    layer's weights are scaled by 50 so that some logits lie past bf16's
    saturation point (|logit| ~ 6.3)."""
    params = scaled_params(j_m.init_params, 0, GAIN_M)
    params["conv_mask_17"]["w"] = params["conv_mask_17"]["w"] * np.float32(50)
    net = MDGenerator()
    net.load_state_dict(jax_params_to_state_dict(params), strict=True)
    img, sketch, _ = _inputs(0, H=32, W=32)
    x, s = nchw(img).bfloat16(), nchw(sketch).bfloat16()
    with torch.no_grad():
        soft16, im16 = net(x, s)
        soft32, im32 = net(x, s, mask_dtype=torch.float32)
    assert soft16.dtype == torch.bfloat16 and soft32.dtype == torch.float32
    assert torch.equal(im16, im32)
    torch.testing.assert_close(soft32.bfloat16().float(), soft16.float(),
                               rtol=2 ** -8, atol=0)
    saturated = (soft16 == 0) | (soft16 == 1)
    assert saturated.any()
    assert ((soft32[saturated] > 0) & (soft32[saturated] < 1)).any()


@pytest.mark.parametrize("impl,pool_type,joint", [
    ("dense", "max", True),          # the released flags
    ("kernel", "max", True),         # the kernel's CPU (plain) path
    ("dense", "avg", False),
])
def test_deepfill_matches_jax(impl, pool_type, joint):
    params = scaled_params(j_g.init_params, 1, GAIN_G)
    img, sketch, mask = _inputs(1)
    jcfg = j_g.DeepFillConfig(pool_type=pool_type, joint_train_inp=joint)
    want1, want2 = j_g.apply(params, jnp.asarray(img), jnp.asarray(img),
                             jnp.asarray(mask), jnp.asarray(mask),
                             jnp.asarray(sketch), config=jcfg, precision=HIGH)
    net = DeepFillC2Generator(DeepFillConfig(
        pool_type=pool_type, joint_train_inp=joint, attention_impl=impl))
    net.load_state_dict(jax_params_to_state_dict(params),
                        strict=True)
    with torch.no_grad():
        got1, got2 = net(nchw(img), nchw(img), nchw(mask), nchw(mask),
                         nchw(sketch))
    np.testing.assert_allclose(nhwc(got1), np.asarray(want1), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(nhwc(got2), np.asarray(want2), rtol=0,
                               atol=ATOL)
    assert np.asarray(want2).std() > 0.05


def test_layer_names_match_jax():
    """Every JAX layer is a port layer of the same shape, and nothing
    else: the strict load of a reference state dict depends on it."""
    for j_mod, t_net in ((j_m, MDGenerator()), (j_g, DeepFillC2Generator())):
        want = {f"{name}.weight": (cout, cin, k, k)
                for name, cin, cout, k, *_ in j_mod.LAYER_SPECS}
        got = {k: tuple(v.shape) for k, v in t_net.state_dict().items()
               if k.endswith(".weight")}
        assert got == want
