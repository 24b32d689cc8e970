"""Operation and byte counts of the published architecture, from its layer
tables (``reference/nets.py``), and the published peaks they are held to.

A convolution counts 2 * cout * cin * k * k per output pixel at its
declared width (both halves of a gated layer); a x2 upsample layer convolves
at the doubled size. The attention counts S = Q K^T and P V as products
over the patch grid (N = P = ((H/4 - 4) / 2 + 1)^2 patches of D = 96 * 16).
This is the plain form: a packed, fused or rewritten kernel in the program
does the same work and moves none of these numbers.

A training step counts, per image: the G step's forward of netM and netG,
their backward at twice that, netD's forward on the fake and the real and
its backward to the fake, VGG19 (to relu5_1) forward on both and backward
to the fake; then the D step's forward of netM and netG without gradient,
netD's forward on both and its backward at twice that:
4 (M + G) + 7 D + 3 VGG.
"""

from __future__ import annotations

from benchmark.reference import nets

# Published dense peaks (NVIDIA data sheets), FLOP/s and bytes/s, by the
# form factor in the card's name; SXM when the name says none.
PEAKS = {
    "PCIe": {"bfloat16": 756e12, "tf32": 378e12, "float32": 51.2e12,
             "bytes": 2.0e12},
    "NVL": {"bfloat16": 835e12, "tf32": 417.5e12, "float32": 60e12,
            "bytes": 3.9e12},
    "SXM": {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12,
            "bytes": 3.35e12},
}


def peaks(card_name: str) -> dict:
    for key in ("PCIe", "NVL"):
        if key in card_name:
            return PEAKS[key]
    return PEAKS["SXM"]


def _run(specs, res: int) -> tuple[float, int]:
    flops = 0.0
    for _name, cin, cout, k, stride, _rate, _act, up in specs:
        if up:
            res *= 2
        res //= stride
        flops += 2.0 * cout * cin * k * k * res * res
    return flops, res


def net_m(size: int) -> float:
    enc, _ = _run(nets._M_ENCODER, size)
    return (enc + _run(nets.M_IMAGE_DECODER, size // 4)[0]
            + _run(nets.M_MASK_DECODER, size // 4)[0])


def attention_grid(size: int) -> tuple[int, int]:
    """(patches N = P, patch vector length D) at an image size."""
    side = (size // 4 - nets.ATTN["patch"]) // nets.ATTN["stride"] + 1
    return side * side, 2 * nets.CNUM * nets.ATTN["patch"] ** 2


def attention(size: int) -> float:
    n, d = attention_grid(size)
    return 4.0 * n * n * d


def net_g_convs(size: int) -> float:
    q = size // 4
    return (_run(nets.G_CONV, size)[0] + _run(nets.G_CONV_DEC, q)[0]
            + _run(nets.G_WCONV, size)[0] + _run(nets.G_XCONV, size)[0]
            + _run(nets.G_PMCONV, size)[0] + _run(nets.G_PM_POST, q)[0]
            + _run(nets.G_ALLCONV_DEC, q)[0])


def net_d(size: int) -> float:
    flops, res = 0.0, size
    for _name, cin, cout in nets.D_LAYERS:
        res = (res + 1) // 2
        flops += 2.0 * cout * cin * 25 * res * res
    return flops


def vgg(size: int) -> float:
    flops, res, cin = 0.0, size, 3
    for c in nets.VGG_CFG:
        if c == "M":
            res //= 2
            continue
        flops += 2.0 * c * cin * 9 * res * res
        cin = c
    return flops


def edit(size: int) -> float:
    """One edit: netM, netG's convolutions and its attention."""
    return net_m(size) + net_g_convs(size) + attention(size)


def train_step_per_image(size: int) -> float:
    return 4 * edit(size) + 7 * net_d(size) + 3 * vgg(size)


def attention_forward(B: int, N: int, P: int, D: int, kept, esize: int,
                      lse: bool) -> tuple[float, float]:
    """(FLOP, bytes) the attention forward needs: S over the kept keys (a
    gated key's logit is 0 without a product), P V over every key; the one
    patch tensor (queries, keys and values) read once, keep and the key
    scale read, the float32 output (and logsumexp) written once.
    ``kept``: kept keys per batch row."""
    flops = sum(2.0 * N * D * (k + P) for k in kept)
    nbytes = (B * N * D * esize + B * P * 4 + B * D * 4 + B * N * D * 4
              + (B * N * 4 if lse else 0))
    return flops, nbytes


def attention_backward(B: int, N: int, P: int, D: int, kept,
                       esize: int) -> tuple[float, float]:
    """(FLOP, bytes) dQ, dK and dV need: dV = P^T dO over every key, dP,
    dQ and dK over the kept keys only (a gated key's logit is a constant);
    the patch tensor, dO, logsumexp, delta, keep and the key scale read
    once, the three float32 gradients written once."""
    flops = sum(2.0 * N * D * (P + 3 * k) for k in kept)
    nbytes = (B * N * D * esize + B * N * D * 4 + 2 * B * N * 4 + B * P * 4
              + B * D * 4 + 3 * B * N * D * 4)
    return flops, nbytes
