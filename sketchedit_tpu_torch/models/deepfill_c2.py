"""netG, the two-stage gated-conv generator with contextual attention
(counterpart of ``sketchedit_tpu/models/deepfill_c2.py``).

1. a coarse encoder-decoder (conv1...conv17) over ``[x*(1-mask), guide, mask]``;
2. a latent encoder (wconv1...wconv10) over ``[x2*mask2, guide or 0, mask2]``
   whose H/4 features are pooled (max or mean) to one vector per image and
   broadcast back;
3. a stage-2 hallucination encoder (xconv1...xconv10) over the composite;
4. a stage-2 attention encoder (pmconv1...pmconv6, contextual attention,
   pmconv9...pmconv10), concatenated with (3) into the allconv decoder.

Attribute names are the reference layer names. At the released splitcam
configuration the contextual attention runs through the CUDA kernel, the
dense version, or the kernel with its query patches split over
``attention_devices`` (``attention_impl``); any other ``attention``
configuration runs ``splitcam_attention`` (dense torch), whatever
``attention_impl`` says, as the JAX netG does. With ``pack`` (None:
``use_packing`` of the batch, dtype and mode) the front pair of all four
encoders and the tails of both decoders run on the space-to-depth packed
grid (``ops/packed_tail.py``; five-layer tails under
``use_mid_packing``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from sketchedit_tpu_torch.models.md_generator import SpecNet, build_layers
from sketchedit_tpu_torch.ops.attention import (
    SplitCAMConfig, contextual_attention, splitcam_attention)
from sketchedit_tpu_torch.ops.attention_cuda import contextual_attention_fused
from sketchedit_tpu_torch.ops.image import avg_pool2d
from sketchedit_tpu_torch.ops.packed_tail import use_mid_packing, use_packing
from sketchedit_tpu_torch.parallel.sharded_attention import (
    contextual_attention_sharded)

CNUM = 48
ATTENTION_IMPLS = ("auto", "dense", "kernel", "sharded")


@dataclass(frozen=True)
class DeepFillConfig:
    """The reference generator's flags plus the model-level
    --joint_train_inp. Defaults are the released configuration."""
    use_cam: bool = True
    pool_type: str = "max"          # 'avg' | 'max'
    no_mask_cc: bool = False
    no_mask_coarse: bool = False
    joint_train_inp: bool = True
    # 'auto': the kernel on CUDA tensors, the dense version on the CPU;
    # 'sharded': the query-patch axis split over attention_devices
    attention_impl: str = "auto"    # 'auto' | 'dense' | 'kernel' | 'sharded'
    attention_devices: tuple = ()   # torch.devices for 'sharded'
    attention: SplitCAMConfig = field(default_factory=SplitCAMConfig)

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of "
                             f"{ATTENTION_IMPLS}, got {self.attention_impl!r}")
        if self.attention_impl == "sharded" and not self.attention_devices:
            raise ValueError("attention_impl='sharded' needs "
                             "attention_devices")
        if self.pool_type not in ("avg", "max"):
            raise NotImplementedError(self.pool_type)

    def attention_route(self, device) -> str:
        """How netG's attention runs on ``device``: 'splitcam' (a
        non-released ``attention``), else ``attention_impl`` with 'auto'
        resolved to 'kernel' on CUDA and 'dense' elsewhere."""
        if not self.attention.is_released:
            return "splitcam"
        if self.attention_impl == "auto":
            return "kernel" if torch.device(device).type == "cuda" else "dense"
        return self.attention_impl


def _spec_encoder(prefix: str, cin0: int):
    return [
        (f"{prefix}1",              cin0,     CNUM,   5, 1, 1,  "elu", False),
        (f"{prefix}2_downsample",   CNUM//2,  2*CNUM, 3, 2, 1,  "elu", False),
        (f"{prefix}3",              CNUM,     2*CNUM, 3, 1, 1,  "elu", False),
        (f"{prefix}4_downsample",   CNUM,     4*CNUM, 3, 2, 1,  "elu", False),
        (f"{prefix}5",              2*CNUM,   4*CNUM, 3, 1, 1,  "elu", False),
        (f"{prefix}6",              2*CNUM,   4*CNUM, 3, 1, 1,  "elu", False),
        (f"{prefix}7_atrous",       2*CNUM,   4*CNUM, 3, 1, 2,  "elu", False),
        (f"{prefix}8_atrous",       2*CNUM,   4*CNUM, 3, 1, 4,  "elu", False),
        (f"{prefix}9_atrous",       2*CNUM,   4*CNUM, 3, 1, 8,  "elu", False),
        (f"{prefix}10_atrous",      2*CNUM,   4*CNUM, 3, 1, 16, "elu", False),
    ]


def _spec_decoder(prefix: str, cin11: int):
    return [
        (f"{prefix}11",               cin11,   4*CNUM,  3, 1, 1, "elu", False),
        (f"{prefix}12",               2*CNUM,  4*CNUM,  3, 1, 1, "elu", False),
        (f"{prefix}13_upsample_conv", 2*CNUM,  2*CNUM,  3, 1, 1, "elu", True),
        (f"{prefix}14",               CNUM,    2*CNUM,  3, 1, 1, "elu", False),
        (f"{prefix}15_upsample_conv", CNUM,    CNUM,    3, 1, 1, "elu", True),
        (f"{prefix}16",               CNUM//2, CNUM//2, 3, 1, 1, "elu", False),
        (f"{prefix}17",               CNUM//4, 3,       3, 1, 1, None,  False),
    ]


_SPEC_CONV = _spec_encoder("conv", 5)
_SPEC_CONV_DEC = _spec_decoder("conv", 4*CNUM)      # conv11 reads 96 + 96
_SPEC_WCONV = _spec_encoder("wconv", 5)
_SPEC_XCONV = [
    ("xconv1",            3,        CNUM,   5, 1, 1,  "elu", False),
    ("xconv2_downsample", CNUM//2,  CNUM,   3, 2, 1,  "elu", False),
    ("xconv3",            CNUM//2,  2*CNUM, 3, 1, 1,  "elu", False),
    ("xconv4_downsample", CNUM,     2*CNUM, 3, 2, 1,  "elu", False),
    ("xconv5",            CNUM,     4*CNUM, 3, 1, 1,  "elu", False),
    ("xconv6",            2*CNUM,   4*CNUM, 3, 1, 1,  "elu", False),
    ("xconv7_atrous",     2*CNUM,   4*CNUM, 3, 1, 2,  "elu", False),
    ("xconv8_atrous",     2*CNUM,   4*CNUM, 3, 1, 4,  "elu", False),
    ("xconv9_atrous",     2*CNUM,   4*CNUM, 3, 1, 8,  "elu", False),
    ("xconv10_atrous",    2*CNUM,   4*CNUM, 3, 1, 16, "elu", False),
]
_SPEC_PMCONV = [
    ("pmconv1",            3,       CNUM,   5, 1, 1, "elu",  False),
    ("pmconv2_downsample", CNUM//2, CNUM,   3, 2, 1, "elu",  False),
    ("pmconv3",            CNUM//2, 2*CNUM, 3, 1, 1, "elu",  False),
    ("pmconv4_downsample", CNUM,    4*CNUM, 3, 2, 1, "elu",  False),
    ("pmconv5",            2*CNUM,  4*CNUM, 3, 1, 1, "elu",  False),
    ("pmconv6",            2*CNUM,  4*CNUM, 3, 1, 1, "relu", False),
]
_SPEC_PM_POST = [
    ("pmconv9",  2*CNUM, 4*CNUM, 3, 1, 1, "elu", False),
    ("pmconv10", 2*CNUM, 4*CNUM, 3, 1, 1, "elu", False),
]
_SPEC_ALLCONV_DEC = _spec_decoder("allconv", 4*CNUM)

LAYER_SPECS = (_SPEC_CONV + _SPEC_CONV_DEC + _SPEC_WCONV + _SPEC_XCONV
               + _SPEC_PMCONV + _SPEC_PM_POST + _SPEC_ALLCONV_DEC)


class DeepFillC2Generator(SpecNet):
    def __init__(self, config: DeepFillConfig = DeepFillConfig(), *,
                 device=None, dtype=None):
        super().__init__()
        self.config = config
        build_layers(self, LAYER_SPECS, device=device, dtype=dtype)

    def _attention(self, x, mask):
        """Contextual attention over the pm features, gated by the hole
        mask pooled to feature resolution."""
        mask_s = avg_pool2d(mask, 4, 4)
        impl = self.config.attention_route(x.device)
        if impl == "splitcam":
            return splitcam_attention(x, x, mask_s.detach(),
                                      self.config.attention)
        if impl == "kernel":
            return contextual_attention_fused(x, x, mask_s)
        if impl == "sharded":
            return contextual_attention_sharded(
                x, x, mask_s, self.config.attention_devices)
        return contextual_attention(x, x, mask_s)

    def forward(self, x, x2, mask, mask2, guide=None, pack=None):
        """x, x2 (B, 3, H, W) in [-1, 1]; mask, mask2 (B, 1, H, W) with
        1 = region to synthesize; guide (B, 1, H, W), ones if absent;
        ``pack``: the packed fronts and tails on or off (None:
        ``use_packing(B, dtype, self.training)``). Returns (x_stage1,
        x_stage2), both (B, 3, H, W) in (-1, 1)."""
        cfg = self.config
        B, _, H, W = x.shape
        if pack is None:
            pack = use_packing(B, x.dtype, self.training)
        mid = pack and use_mid_packing()
        if not cfg.no_mask_cc:
            x2 = x2 * mask2
        x = x * (1.0 - mask)
        xin = x
        ones_x = (torch.ones((B, 1, H, W), dtype=x.dtype, device=x.device)
                  if guide is None else guide)
        guide2 = ones_x * 0.0 if cfg.joint_train_inp else ones_x

        h = self._run_encoder(torch.cat([x, ones_x, mask], dim=1),
                              _SPEC_CONV, pack)
        h2 = self._run_encoder(torch.cat([x2, guide2, mask2], dim=1),
                               _SPEC_WCONV, pack)
        if cfg.pool_type == "avg":
            lat = h2.mean(dim=(2, 3), keepdim=True)
        else:
            lat = h2.amax(dim=(2, 3), keepdim=True)
        h = torch.cat([h, lat.expand_as(h2)], dim=1)
        x_stage1 = torch.tanh(self._run_decoder(h, _SPEC_CONV_DEC, pack, mid))

        xnow = x_stage1 if cfg.no_mask_coarse else (
            x_stage1 * mask + xin * (1.0 - mask))
        x_hallu = self._run_encoder(xnow, _SPEC_XCONV, pack)
        pm = self._run_encoder(xnow, _SPEC_PMCONV, pack)
        if cfg.use_cam:
            pm = self._attention(pm, mask)
        pm = self._run(pm, _SPEC_PM_POST)

        h = torch.cat([x_hallu, pm], dim=1)
        x_stage2 = torch.tanh(self._run_decoder(h, _SPEC_ALLCONV_DEC, pack,
                                                mid))
        return x_stage1, x_stage2


def param_groups(names, stage: str = "all"):
    """Layer names trained under ``--update_part`` (DeepFillC2Generator's
    get_param_list): 'all'/'image' -> every layer; 'coarse' -> conv* (the
    stage-1 branch); 'fine' -> the rest; anything else -> none."""
    if stage in ("all", "image"):
        return list(names)
    if stage == "coarse":
        return [n for n in names if n.startswith("conv")]
    if stage == "fine":
        return [n for n in names if not n.startswith("conv")]
    return []
