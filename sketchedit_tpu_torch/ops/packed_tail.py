"""Space-to-depth packed fronts and tails of the gated-conv nets
(counterpart of ``sketchedit_tpu/ops/packed_tail.py``).

The same math as the plain layers on a 2x2-packed grid: half the
resolution, four times the channels. Exact algebra, to float32 roundoff:

* a kxk stride-1 conv (k in {3, 5}) commutes with 2x2 space-to-depth given
  a re-scattered 3x3 kernel over 4Ci -> 4Co channels: output phase (a, b)
  at packed offset dy' reads input phase py where z = a + dy - k//2
  decomposes as dy' = z // 2, py = z % 2 (and likewise for columns);
* a nearest x2 upsample followed by a 3x3 conv emits the packed output
  directly from a 3x3 kernel over Ci -> 4Co channels: colliding taps sum
  ([w0, w1 + w2] and [w0 + w1, w2] per output phase);
* a 3x3 stride-2 conv reads packed input as a 2x2 stride-1 conv over 4Ci
  channels, padded by one row and column at the top and left;
* two upsample + conv layers in a row run pack-2 on both grids through a
  composed 4x4 kernel (``double_packed_deconv_weights``), a conv with
  input dilation 2, which PyTorch computes as a stride-2 transposed conv.

Packed channels are channel-major, as ``F.pixel_unshuffle`` packs them:
index c*4 + (py*2 + px). So the feature half of a gated packed conv is its
first 2*Co channels and ``chunk(2)`` gates it, its per-phase bias is each
bias repeated four times in place, and the gated output is again
channel-major packed. (The JAX package packs phase-major and permutes every
packed kernel to gate-major; either order gives the same unpacked results.)

Weights are OIHW. The packed kernel is formed in float32 from the layer's
weight (one product with a constant 0/1 map) and cast once to the compute
dtype. Without autograd it is built once per (layer, form, dtype) and kept
on the layer (outside its state dict) until the weight is written again
(``load_state_dict``, an optimizer step); under autograd it is formed in
the forward, so the gradients reach the OIHW weights.

Whether a net runs packed is ``use_packing(batch, dtype, training)``
(and the process's TF32 switch), which the nets call when their ``pack``
argument is None.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.nn.functional as F

from sketchedit_tpu_torch.ops.gated_conv import _gate

# Where the packed layers pay, from ABBA times of packed against plain
# edits and train steps at 256^2 on an H100 (scripts/packing_ab_torch.py;
# PERF.md, Findings). Convs on the tensor cores gain: float32 with TF32
# allowed in inference and in training (0.86-0.96x from B = 4, a tie at
# B = 1); bfloat16 in inference from B = 8 on (below it the layout
# conversions around the packed convs cost more host time than they save),
# while its train step at B = 8 lost 1.1-1.26x. float32 on the CUDA cores
# (TF32 off) gains in inference below B = 8 and loses in training (1.16x
# at B = 4 and 8).
PACK_FLOAT32_BELOW = 8
PACK_BFLOAT16_FROM = 8


def _env_switch(name: str):
    """True / False when the variable forces a route, None when it is
    unset or empty ("0" is off, anything else on)."""
    force = os.environ.get(name)
    if force is None or force == "":
        return None
    return force != "0"


def use_packing(batch: int, dtype=torch.float32,
                training: bool = False) -> bool:
    """Whether the nets run their fronts and tails packed for this batch,
    compute dtype and mode (a net's ``training``). bfloat16: from
    ``PACK_BFLOAT16_FROM`` on, not in training. float32 with TF32 allowed
    in cuDNN (``torch.backends.cudnn.allow_tf32``, which
    ``device.set_precision`` sets): always. float32 with TF32 off: below
    ``PACK_FLOAT32_BELOW``, not in training. ``SKETCHEDIT_PACK``
    overrides ("0" off, anything else on; read on every call)."""
    force = _env_switch("SKETCHEDIT_PACK")
    if force is not None:
        return force
    if dtype == torch.bfloat16:
        return not training and batch >= PACK_BFLOAT16_FROM
    if torch.backends.cudnn.allow_tf32:
        return True
    return not training and batch < PACK_FLOAT32_BELOW


def use_mid_packing() -> bool:
    """Whether netG's packed decoder segment spans five layers (both x2
    upsamples, through the double-packed deconv) instead of three. Off
    unless ``SKETCHEDIT_PACK_MID`` turns it on ("0" off, anything else on;
    read on every call)."""
    return bool(_env_switch("SKETCHEDIT_PACK_MID"))


# --- constant tap maps (numpy, built once) --------------------------------

def _build_maps(k: int = 3):
    """Scatter maps from a kxk kernel to the packed kernels:
    t_dec (dy', dx', phase, dy, dx) for the upsample + conv (k = 3 only),
    t_s2d (dy', dx', pin, pout, dy, dx) for the stride-1 conv."""
    half = k // 2
    t_dec = np.zeros((3, 3, 4, k, k), np.float32)
    t_s2d = np.zeros((3, 3, 4, 4, k, k), np.float32)
    for a in range(2):
        for b in range(2):
            pout = a * 2 + b
            for dy in range(k):
                zy = a + dy - half
                dly, py = zy // 2, zy % 2
                for dx in range(k):
                    zx = b + dx - half
                    dlx, px = zx // 2, zx % 2
                    if k == 3:
                        t_dec[dly + 1, dlx + 1, pout, dy, dx] += 1.0
                    t_s2d[dly + 1, dlx + 1, py * 2 + px, pout, dy, dx] += 1.0
    return t_dec, t_s2d


_T_DECONV, _T_S2D = _build_maps(3)
_, _T_S2D5 = _build_maps(5)


def _build_stride2_map():
    """(ky, kx, pin, dy, dx): a stride-2 pad-1 3x3 conv's tap dy reads
    packed row ky of the 2x2 kernel at input phase py."""
    t = np.zeros((2, 2, 4, 3, 3), np.float32)
    rowmap = {0: (0, 1), 1: (1, 0), 2: (1, 1)}
    for dy in range(3):
        kmy, py = rowmap[dy]
        for dx in range(3):
            kmx, px = rowmap[dx]
            t[kmy, kmx, py * 2 + px, dy, dx] += 1.0
    return t


_T_STRIDE2 = _build_stride2_map()


def _build_double_deconv_map():
    """(ky, kx, pin, pout, dy, dx) for the pack-2 (grid G) -> pack-2 (grid
    2G) upsample + conv as one input-dilated 4x4 conv. Per axis: the output
    pixel at 4x resolution q = 4I + 2*alpha + a (I the input cell, alpha
    the output sub-cell, a the output phase) reads the 2x-resolution pixel
    u = (q + dy - 1) // 2 = 2I + alpha + s with s = (a + dy - 1) // 2,
    which is packed cell I + (alpha + s) // 2 at phase (alpha + s) % 2 and
    kernel index k = 2 * ((alpha + s) // 2) + 2 - alpha (always 0..3)."""
    t = np.zeros((4, 4, 4, 4, 3, 3), np.float32)
    for ay in range(2):
        for dy in range(3):
            sy = (ay + dy - 1) // 2
            for aly in range(2):
                ty = aly + sy
                ky, piny = 2 * (ty // 2) + 2 - aly, ty % 2
                for ax in range(2):
                    for dx in range(3):
                        sx = (ax + dx - 1) // 2
                        for alx in range(2):
                            tx = alx + sx
                            kx, pinx = 2 * (tx // 2) + 2 - alx, tx % 2
                            t[ky, kx, piny * 2 + pinx, ay * 2 + ax,
                              dy, dx] += 1.0
    return t


_T_DOUBLE_DECONV = _build_double_deconv_map()


def _map_matrix(t, out_axes):
    """A tap map t (..., dy, dx) as a (k*k, targets) matrix, the targets
    laid out as ``out_axes`` (a permutation of t's leading axes): one
    product with the flattened kernel applies the map, sums of colliding
    taps included."""
    k2 = t.shape[-1] * t.shape[-2]
    flat = t.reshape(*t.shape[:-2], k2).transpose(*out_axes, len(out_axes))
    return np.ascontiguousarray(flat.reshape(-1, k2).T)


# target layouts: (pout, pin, ky, kx) for the kernels with packed outputs,
# (pin, ky, kx) for the stride-2 one, whose output is unpacked
_MAPS = {
    "deconv": (_map_matrix(_T_DECONV, (2, 0, 1)), (4, 3, 3)),
    "s2d3": (_map_matrix(_T_S2D, (3, 2, 0, 1)), (4, 4, 3, 3)),
    "s2d5": (_map_matrix(_T_S2D5, (3, 2, 0, 1)), (4, 4, 3, 3)),
    "stride2": (_map_matrix(_T_STRIDE2, (2, 0, 1)), (4, 2, 2)),
    "double": (_map_matrix(_T_DOUBLE_DECONV, (3, 2, 0, 1)), (4, 4, 4, 4)),
}
_MAPS_ON: dict = {}


def _apply_map(w, name):
    """OIHW ``w`` through map ``name``: (Co, Ci, *target layout), in w's
    dtype. The map's entries are 0 and 1, so in float32 with TF32 off the
    product is the exact sum of the colliding taps (TF32, where allowed,
    rounds the weights as the TF32 conv does anyway)."""
    mat, layout = _MAPS[name]
    key = (name, w.device, w.dtype)
    m = _MAPS_ON.get(key)
    if m is None:
        with torch.inference_mode(False):   # autograd may save it later
            m = torch.as_tensor(mat, device=w.device, dtype=w.dtype)
        if not _tracing():      # a trace's tensors are its own
            _MAPS_ON[key] = m
    co, ci = w.shape[:2]
    return (w.reshape(co * ci, -1) @ m).reshape(co, ci, *layout)


def deconv_packed_weights(w):
    """(Co, Ci, 3, 3) -> (4Co, Ci, 3, 3): nearest x2 upsample + conv
    emitting the packed output."""
    co, ci = w.shape[:2]
    wp = _apply_map(w, "deconv")                     # (co, ci, P, 3, 3)
    return wp.permute(0, 2, 1, 3, 4).reshape(4 * co, ci, 3, 3)


def s2d_conv_weights(w):
    """(Co, Ci, k, k), k in {3, 5} -> (4Co, 4Ci, 3, 3): the same stride-1
    conv on the packed grid (a 5x5's taps still span +-1 packed rows)."""
    co, ci, k = w.shape[:3]
    if k not in (3, 5):
        raise ValueError(f"s2d_conv_weights takes 3x3 or 5x5, got {k}x{k}")
    wp = _apply_map(w, f"s2d{k}")                    # (co, ci, P, Q, 3, 3)
    return wp.permute(0, 2, 1, 3, 4, 5).reshape(4 * co, 4 * ci, 3, 3)


def s2d_stride2_weights(w):
    """(Co, Ci, 3, 3) stride-2 pad-1 conv over packed input -> (Co, 4Ci,
    2, 2), a stride-1 conv with padding one row and column at the top and
    left; its output is the ordinary half-resolution feature map."""
    co, ci = w.shape[:2]
    return _apply_map(w, "stride2").reshape(co, 4 * ci, 2, 2)


def double_packed_deconv_weights(w):
    """(Co, Ci, 3, 3) -> (4Co, 4Ci, 4, 4) for the pack-2 (grid G) -> pack-2
    (grid 2G) upsample + conv: a conv with input dilation 2 and padding 2
    (``_dilated_conv``)."""
    co, ci = w.shape[:2]
    wp = _apply_map(w, "double")                     # (co, ci, P, Q, 4, 4)
    return wp.permute(0, 2, 1, 3, 4, 5).reshape(4 * co, 4 * ci, 4, 4)


def space_to_depth2x(x):
    """(B, C, H, W) -> (B, 4C, H/2, W/2), channel-major packed. H and W
    must be even."""
    H, W = x.shape[-2:]
    if H % 2 or W % 2:
        raise ValueError(f"space_to_depth2x needs an even height and width, "
                         f"got {H}x{W}")
    return F.pixel_unshuffle(x, 2)


def depth_to_space2x(x):
    """(B, 4C, h, w) channel-major packed -> (B, C, 2h, 2w)."""
    return F.pixel_shuffle(x, 2)


# --- packed layers ---------------------------------------------------------

_FORMS = {"deconv": deconv_packed_weights, "s2d": s2d_conv_weights,
          "stride2": s2d_stride2_weights,
          "double": double_packed_deconv_weights}


def _tracing() -> bool:
    compiler = torch.compiler
    return compiler.is_compiling() or (
        hasattr(compiler, "is_exporting") and compiler.is_exporting())


_FROZEN = False


@contextlib.contextmanager
def frozen_packed_params():
    """Inside a trace (``torch.export``) take each layer's kept packed pair
    as a constant, where the layer has one, instead of forming it in the
    program. The caller runs the model once without autograd just before,
    so that the kept pairs are those of the current weights."""
    global _FROZEN
    _FROZEN = True
    try:
        yield
    finally:
        _FROZEN = False


def packed_params(layer, form: str, dtype):
    """``layer``'s (weight, bias) in packed ``form`` ('deconv', 's2d',
    'stride2', 'double'), in ``dtype``. Without autograd the pair is kept
    on the layer, in a plain attribute that the state dict does not see,
    and formed again once the weight or bias has been written
    (``_version``) or replaced; under autograd, and in a trace, it is
    formed in the forward (see ``frozen_packed_params``)."""
    w, b = layer.weight, layer.bias

    def build():        # in float32, or wider
        wp = _FORMS[form](w.to(torch.promote_types(w.dtype, torch.float32)))
        wp = wp.to(dtype)
        # per phase, channel-major (expand, not repeat_interleave, whose
        # CUDA form waits for the device)
        bp = b if form == "stride2" else b[:, None].expand(-1, 4).reshape(-1)
        return wp, bp.to(dtype)

    cache = layer.__dict__.setdefault("_packed_cache", {})
    key = (form, dtype, w.device)
    if _tracing():
        hit = cache.get(key) if _FROZEN else None
        return build() if hit is None else hit[1:]
    if torch.is_grad_enabled():
        return build()
    stamp = (w.data_ptr(), w._version, b.data_ptr(), b._version)
    hit = cache.get(key)
    if hit is None or hit[0] != stamp:
        hit = cache[key] = (stamp, *build())
    return hit[1:]


def _dilated_conv(x, w, b):
    """The JAX form's conv with input dilation 2 and padding 2 (4x4 kernel,
    input n -> output 2n): a stride-2 transposed conv of the flipped,
    in/out-swapped kernel with padding 1."""
    return F.conv_transpose2d(x, w.flip(-2, -1).transpose(0, 1), b,
                              stride=2, padding=1)


def _packed_conv(layer, x, form: str):
    """``layer`` in packed ``form`` on ``x``, gated where the plain layer
    gates (channel-major packing keeps the feature half first)."""
    w, b = packed_params(layer, form, x.dtype)
    if form == "double":
        y = _dilated_conv(x, w, b)
    elif form == "stride2":
        y = F.conv2d(F.pad(x, (1, 0, 1, 0)), w, b)
    else:
        y = F.conv2d(x, w, b, padding=1)
    return _gate(y, layer.out_channels, layer.activation)


def packed_encoder_front(conv1, conv2, x):
    """conv1 (5x5 or 3x3, stride 1, gated) and conv2_downsample (3x3,
    stride 2, gated) on the packed half-resolution grid. ``x`` is the
    full-resolution input (even height and width); the result is conv2's
    ordinary half-resolution gated output."""
    h = _packed_conv(conv1, space_to_depth2x(x), "s2d")
    return _packed_conv(conv2, h, "stride2")


def packed_decoder_tail(up, mid, head, x):
    """up (the last upsample conv), mid (gated 3x3) and head (3x3, no gate)
    on the packed grid at ``x``'s resolution; returns the head's raw output
    at twice that resolution (the caller applies tanh or sigmoid)."""
    h = _packed_conv(up, x, "deconv")
    h = _packed_conv(mid, h, "s2d")
    return depth_to_space2x(_packed_conv(head, h, "s2d"))


def packed_decoder_tail5(up1, mid1, up2, mid2, head, x):
    """The last five decoder layers (conv13_upsample, conv14,
    conv15_upsample, conv16, conv17) on packed grids: the 2x segment pack-2
    on ``x``'s grid, the 4x segment pack-2 on the doubled grid through the
    double-packed deconv; returns the head's raw output at four times
    ``x``'s resolution."""
    h = _packed_conv(up1, x, "deconv")
    h = _packed_conv(mid1, h, "s2d")
    h = _packed_conv(up2, h, "double")
    h = _packed_conv(mid2, h, "s2d")
    return depth_to_space2x(_packed_conv(head, h, "s2d"))
