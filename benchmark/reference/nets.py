"""Plain PyTorch forward passes of the released SketchEdit nets, in float32.

A frozen copy of the published architecture (editline2: netM
``MDGenerator``, netG ``deepfillc2`` with cnum 48, ``--use_cam --pool_type
max --joint_train_inp``; netD ``sngan``; the VGG19 of the perceptual loss),
written against the reference implementation's layer tables and equations.
It imports nothing of the measured program: weights are plain dicts of
tensors keyed ``<layer>.weight`` / ``<layer>.bias`` (and ``<layer>.u`` for
netD's power-iteration vectors), the state-dict names the program's nets
load.

Every convolution and attention product goes through ``q`` (a
``precision.Precision``): the identity for the reference, a rounding of both
operands to a lower precision for the control. The convolutions run in
float32; the caller turns TF32 off.

Departures from the released code, none of which changes a result: the
dense attention forms its logits once over all key patches (the released
code loops over the batch); the VGG features stop at relu5_1, the last tap
the loss reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CNUM = 48

# (name, cin, cout declared, ksize, stride, rate, activation, upsample first)
_M_ENCODER = [
    ("conv1", 4, CNUM, 5, 1, 1, "elu", False),
    ("conv2_downsample", CNUM // 2, 2 * CNUM, 3, 2, 1, "elu", False),
    ("conv3", CNUM, 2 * CNUM, 3, 1, 1, "elu", False),
    ("conv4_downsample", CNUM, 4 * CNUM, 3, 2, 1, "elu", False),
    ("conv5", 2 * CNUM, 4 * CNUM, 3, 1, 1, "elu", False),
    ("conv6", 2 * CNUM, 4 * CNUM, 3, 1, 1, "elu", False),
    ("conv7_atrous", 2 * CNUM, 4 * CNUM, 3, 1, 2, "elu", False),
    ("conv8_atrous", 2 * CNUM, 4 * CNUM, 3, 1, 4, "elu", False),
    ("conv9_atrous", 2 * CNUM, 4 * CNUM, 3, 1, 8, "elu", False),
    ("conv10_atrous", 2 * CNUM, 4 * CNUM, 3, 1, 16, "elu", False),
]


def _decoder(prefix, cin11, out_ch):
    return [
        (f"{prefix}11", cin11, 4 * CNUM, 3, 1, 1, "elu", False),
        (f"{prefix}12", 2 * CNUM, 4 * CNUM, 3, 1, 1, "elu", False),
        (f"{prefix}13_upsample_conv", 2 * CNUM, 2 * CNUM, 3, 1, 1, "elu", True),
        (f"{prefix}14", CNUM, 2 * CNUM, 3, 1, 1, "elu", False),
        (f"{prefix}15_upsample_conv", CNUM, CNUM, 3, 1, 1, "elu", True),
        (f"{prefix}16", CNUM // 2, CNUM // 2, 3, 1, 1, "elu", False),
        (f"{prefix}17", CNUM // 4, out_ch, 3, 1, 1, None, False),
    ]


def _encoder(prefix, cin0):
    return [(prefix + name[4:], cin0 if i == 0 else cin, cout, k, s, r, a, u)
            for i, (name, cin, cout, k, s, r, a, u) in enumerate(_M_ENCODER)]


M_IMAGE_DECODER = _decoder("conv", 2 * CNUM, 3)
M_MASK_DECODER = _decoder("conv_mask_", 2 * CNUM, 1)
M_LAYERS = _M_ENCODER + M_IMAGE_DECODER + M_MASK_DECODER

G_CONV = _encoder("conv", 5)
G_CONV_DEC = _decoder("conv", 4 * CNUM, 3)
G_WCONV = _encoder("wconv", 5)
G_XCONV = [
    ("xconv1", 3, CNUM, 5, 1, 1, "elu", False),
    ("xconv2_downsample", CNUM // 2, CNUM, 3, 2, 1, "elu", False),
    ("xconv3", CNUM // 2, 2 * CNUM, 3, 1, 1, "elu", False),
    ("xconv4_downsample", CNUM, 2 * CNUM, 3, 2, 1, "elu", False),
    ("xconv5", CNUM, 4 * CNUM, 3, 1, 1, "elu", False),
    ("xconv6", 2 * CNUM, 4 * CNUM, 3, 1, 1, "elu", False),
    ("xconv7_atrous", 2 * CNUM, 4 * CNUM, 3, 1, 2, "elu", False),
    ("xconv8_atrous", 2 * CNUM, 4 * CNUM, 3, 1, 4, "elu", False),
    ("xconv9_atrous", 2 * CNUM, 4 * CNUM, 3, 1, 8, "elu", False),
    ("xconv10_atrous", 2 * CNUM, 4 * CNUM, 3, 1, 16, "elu", False),
]
G_PMCONV = [
    ("pmconv1", 3, CNUM, 5, 1, 1, "elu", False),
    ("pmconv2_downsample", CNUM // 2, CNUM, 3, 2, 1, "elu", False),
    ("pmconv3", CNUM // 2, 2 * CNUM, 3, 1, 1, "elu", False),
    ("pmconv4_downsample", CNUM, 4 * CNUM, 3, 2, 1, "elu", False),
    ("pmconv5", 2 * CNUM, 4 * CNUM, 3, 1, 1, "elu", False),
    ("pmconv6", 2 * CNUM, 4 * CNUM, 3, 1, 1, "relu", False),
]
G_PM_POST = [
    ("pmconv9", 2 * CNUM, 4 * CNUM, 3, 1, 1, "elu", False),
    ("pmconv10", 2 * CNUM, 4 * CNUM, 3, 1, 1, "elu", False),
]
G_ALLCONV_DEC = _decoder("allconv", 4 * CNUM, 3)
G_LAYERS = (G_CONV + G_CONV_DEC + G_WCONV + G_XCONV + G_PMCONV + G_PM_POST
            + G_ALLCONV_DEC)

# netD (SN-PatchGAN): (name, cin, cout), all 5x5 stride 2, leaky slope 0.2
D_LAYERS = [("dconv1", 7, 64), ("dconv2", 64, 128), ("dconv3", 128, 256),
            ("dconv4", 256, 256), ("dconv5", 256, 256), ("dconv6", 256, 256)]

# VGG19 convolutions up to relu5_1 ("M": 2x2 max pool); taps after the
# relu of conv1_1, conv2_1, conv3_1, conv4_1, conv5_1
VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
           512, 512, 512, 512, "M", 512]
VGG_TAPS = (0, 2, 4, 8, 12)          # conv index whose relu is a tap
VGG_TAP_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)
VGG_CONVS = 16                        # VGG19's 16 convs (weights held)
ATTN = {"patch": 4, "stride": 2, "softmax_scale": 10.0, "th": 0.1}

_ACT = {"elu": F.elu, "relu": F.relu}


def gated(x, params, spec, q):
    """One gated conv layer: (upsample x2), conv, and unless the declared
    width is 3 or the layer has no activation, act(a) * sigmoid(g) over the
    two channel halves."""
    name, _cin, cout, k, stride, rate, act, up = spec
    if up:
        x = F.interpolate(x, scale_factor=2, mode="nearest")
    y = F.conv2d(q(x), q(params[f"{name}.weight"]), params[f"{name}.bias"],
                 stride=stride, padding=rate * (k - 1) // 2, dilation=rate)
    if cout == 3 or act is None:
        return y
    a, g = y.chunk(2, dim=1)
    return _ACT[act](a) * torch.sigmoid(g)


def run(x, params, specs, q):
    for spec in specs:
        x = gated(x, params, spec, q)
    return x


def net_m(params, image, sketch, q):
    """netM: (soft mask, mask image) from image in [-1, 1] and sketch in
    {0, 1}, NCHW. The image decoder reads conv9's output, the mask decoder
    conv10's, as in the released code."""
    h = run(torch.cat([image, sketch], 1), params, _M_ENCODER[:-1], q)
    bneck = gated(h, params, _M_ENCODER[-1], q)
    mask_image = torch.tanh(run(h, params, M_IMAGE_DECODER, q))
    logits = run(bneck, params, M_MASK_DECODER, q)
    return torch.sigmoid(logits), mask_image


def contextual_attention(f, mask, q):
    """The released contextual attention with foreground = background = f
    (B, C, H, W) and the hole mask at feature resolution: keys are the 4x4
    patches (stride 2) of f over f's global per-channel L2 norm, values the
    raw patches; a key patch whose valid share is at most 0.1 has its logit
    multiplied by 0; softmax with scale 10; overlap-add fold."""
    B, C, H, W = f.shape
    k, s = ATTN["patch"], ATTN["stride"]
    norm = torch.sqrt((f * f).sum(dim=(2, 3), keepdim=True) + 1e-8)
    V = F.unfold(f, k, stride=s).transpose(1, 2)
    K = F.unfold(f / norm, k, stride=s).transpose(1, 2)
    valid = F.avg_pool2d(1.0 - mask, k, s).reshape(B, -1)
    keep = (valid > ATTN["th"]).to(f.dtype)
    logits = torch.bmm(q(V), q(K).transpose(1, 2))
    w = torch.softmax(logits * keep[:, None, :] * ATTN["softmax_scale"], -1)
    out = torch.bmm(q(w), q(V))
    return F.fold(out.transpose(1, 2), (H, W), k, stride=s)


def net_g(params, x, x2, mask, mask2, guide, q):
    """netG (deepfillc2, use_cam, pool max, joint_train_inp): returns
    (x_stage1, x_stage2)."""
    B, _, H, W = x.shape
    x2 = x2 * mask2
    x = x * (1.0 - mask)
    xin = x
    guide2 = guide * 0.0
    h = run(torch.cat([x, guide, mask], 1), params, G_CONV, q)
    h2 = run(torch.cat([x2, guide2, mask2], 1), params, G_WCONV, q)
    lat = h2.amax(dim=(2, 3), keepdim=True)
    h = torch.cat([h, lat.expand_as(h2)], 1)
    x1 = torch.tanh(run(h, params, G_CONV_DEC, q))
    xnow = x1 * mask + xin * (1.0 - mask)
    hallu = run(xnow, params, G_XCONV, q)
    pm = run(xnow, params, G_PMCONV, q)
    pm = contextual_attention(pm, F.avg_pool2d(mask, 4, 4), q)
    pm = run(pm, params, G_PM_POST, q)
    x2_out = torch.tanh(run(torch.cat([hallu, pm], 1), params,
                            G_ALLCONV_DEC, q))
    return x1, x2_out


def spectral_normalize(w, u):
    """One power-iteration step from ``u``; the iteration vectors carry no
    gradient. Returns (w / sigma, new u)."""
    wm = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = u @ wm
        v = v / (torch.linalg.vector_norm(v) + 1e-12)
        u_new = wm @ v
        u_new = u_new / (torch.linalg.vector_norm(u_new) + 1e-12)
    sigma = u_new @ (wm @ v)
    return w / (sigma + 1e-12), u_new


def net_d(params, image, line, cc, q):
    """netD: patch logits and the new power-iteration vectors."""
    x = torch.cat([image, line, cc], 1)
    new_u = {}
    for name, _cin, _cout in D_LAYERS:
        w, new_u[name] = spectral_normalize(params[f"{name}.weight"],
                                            params[f"{name}.u"])
        x = F.leaky_relu(F.conv2d(q(x), q(w), params[f"{name}.bias"],
                                  stride=2, padding=2), 0.2)
    return x, new_u


def vgg_features(vgg, x, q):
    """The five relu taps of VGG19 for x in [-1, 1] (ImageNet
    normalization); ``vgg`` is a list of (OIHW weight, bias)."""
    mean = x.new_tensor([0.485, 0.456, 0.406]).reshape(1, 3, 1, 1)
    std = x.new_tensor([0.229, 0.224, 0.225]).reshape(1, 3, 1, 1)
    h = ((x + 1.0) / 2.0 - mean) / std
    feats, i = [], 0
    for c in VGG_CFG:
        if c == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        w, b = vgg[i]
        h = F.relu(F.conv2d(q(h), q(w), b, padding=1))
        if i in VGG_TAPS:
            feats.append(h)
        i += 1
    return feats
