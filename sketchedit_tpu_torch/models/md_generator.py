"""netM, the mask-prediction network (counterpart of
``sketchedit_tpu/models/md_generator.py``).

From (image, partial sketch) it predicts a soft mask of the region the
sketch edits, plus a guess of the edited image that only the training loss
reads. A gated-conv encoder (two stride-2 downsamples, then dilations
2/4/8/16 at H/4) feeds two gated-conv decoders. The reference's quirk is
kept: the image decoder (conv11...conv17) reads the conv9 output, and only
the mask decoder (conv_mask_11...17) reads the conv10 bottleneck.

Attribute names are the reference layer names, so a reference state dict
loads strictly.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from sketchedit_tpu_torch.ops.gated_conv import GatedConv2d

CNUM = 48

# (name, cin_effective, cout_declared, ksize, stride, rate, activation, deconv)
_ENCODER = [
    ("conv1",              4,        CNUM,     5, 1, 1,  "elu", False),
    ("conv2_downsample",   CNUM//2,  2*CNUM,   3, 2, 1,  "elu", False),
    ("conv3",              CNUM,     2*CNUM,   3, 1, 1,  "elu", False),
    ("conv4_downsample",   CNUM,     4*CNUM,   3, 2, 1,  "elu", False),
    ("conv5",              2*CNUM,   4*CNUM,   3, 1, 1,  "elu", False),
    ("conv6",              2*CNUM,   4*CNUM,   3, 1, 1,  "elu", False),
    ("conv7_atrous",       2*CNUM,   4*CNUM,   3, 1, 2,  "elu", False),
    ("conv8_atrous",       2*CNUM,   4*CNUM,   3, 1, 4,  "elu", False),
    ("conv9_atrous",       2*CNUM,   4*CNUM,   3, 1, 8,  "elu", False),
    ("conv10_atrous",      2*CNUM,   4*CNUM,   3, 1, 16, "elu", False),
]


def _decoder_spec(prefix: str, out_ch: int):
    return [
        (f"{prefix}11",                2*CNUM,  4*CNUM,  3, 1, 1, "elu", False),
        (f"{prefix}12",                2*CNUM,  4*CNUM,  3, 1, 1, "elu", False),
        (f"{prefix}13_upsample_conv",  2*CNUM,  2*CNUM,  3, 1, 1, "elu", True),
        (f"{prefix}14",                CNUM,    2*CNUM,  3, 1, 1, "elu", False),
        (f"{prefix}15_upsample_conv",  CNUM,    CNUM,    3, 1, 1, "elu", True),
        (f"{prefix}16",                CNUM//2, CNUM//2, 3, 1, 1, "elu", False),
        (f"{prefix}17",                CNUM//4, out_ch,  3, 1, 1, None,  False),
    ]


_IMAGE_DECODER = _decoder_spec("conv", 3)
_MASK_DECODER = _decoder_spec("conv_mask_", 1)

LAYER_SPECS = _ENCODER + _IMAGE_DECODER + _MASK_DECODER


def build_layers(module: nn.Module, specs, *, device=None, dtype=None):
    """Add one ``GatedConv2d`` per spec row to ``module``, named as the row."""
    for name, cin, cout, ksize, stride, rate, act, deconv in specs:
        module.add_module(name, GatedConv2d(
            cin, cout, ksize, stride, rate, act, deconv,
            device=device, dtype=dtype))


class MDGenerator(nn.Module):
    def __init__(self, *, device=None, dtype=None):
        super().__init__()
        build_layers(self, LAYER_SPECS, device=device, dtype=dtype)

    def _run(self, x, specs):
        for spec in specs:
            x = getattr(self, spec[0])(x)
        return x

    def forward(self, image, sketch, mask_dtype=None):
        """image (B, 3, H, W) in [-1, 1], sketch (B, 1, H, W) in {0, 1}.
        Returns (soft_mask (B, 1, H, W), mask_image (B, 3, H, W)).
        ``mask_dtype`` widens the sigmoid (training passes float32 under
        bfloat16 compute: a bf16 sigmoid is exactly 0 or 1 past |logit| ~
        6.3, which kills the mask-BCE gradient on confidently wrong
        pixels)."""
        x = self._run(torch.cat([image, sketch], dim=1), _ENCODER[:-1])
        x_bneck = self.conv10_atrous(x)     # only the mask branch reads it
        mask_image = torch.tanh(self._run(x, _IMAGE_DECODER))
        logits = self._run(x_bneck, _MASK_DECODER)
        if mask_dtype is not None:
            logits = logits.to(mask_dtype)
        return torch.sigmoid(logits), mask_image


def param_groups(names, stage: str = "all"):
    """Layer names trained under ``--update_part`` (MDGenerator's
    get_param_list): 'all'/'mask' -> every layer; 'maskim' -> layers named
    conv*, which in this net is every layer too (the reference's quirk,
    kept); anything else -> none."""
    if stage in ("all", "mask"):
        return list(names)
    if stage == "maskim":
        return [n for n in names if n.startswith("conv")]
    return []
