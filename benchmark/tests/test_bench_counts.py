"""The frozen operation counts against a hand count from the layer specs
and against PyTorch's own count of the plain reference."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, weights
from benchmark.reference import edit, nets


def conv(cout, cin, k, res):
    return 2.0 * cout * cin * k * k * res * res


def hand_net_m(s):
    q, h = s // 4, s // 2
    enc = (conv(48, 4, 5, s) + conv(96, 24, 3, h) + conv(96, 48, 3, h)
           + conv(192, 48, 3, q) + 6 * conv(192, 96, 3, q))
    dec = lambda out: (2 * conv(192, 96, 3, q) + conv(96, 96, 3, h)
                       + conv(96, 48, 3, h) + conv(48, 48, 3, s)
                       + conv(24, 24, 3, s) + conv(out, 12, 3, s))
    return enc + dec(3) + dec(1)


def hand_net_g(s):
    q, h = s // 4, s // 2
    enc = lambda cin: (conv(48, cin, 5, s) + conv(96, 24, 3, h)
                       + conv(96, 48, 3, h) + conv(192, 48, 3, q)
                       + 6 * conv(192, 96, 3, q))
    dec = lambda cin: (conv(192, cin, 3, q) + conv(192, 96, 3, q)
                       + conv(96, 96, 3, h) + conv(96, 48, 3, h)
                       + conv(48, 48, 3, s) + conv(24, 24, 3, s)
                       + conv(3, 12, 3, s))
    xconv = (conv(48, 3, 5, s) + conv(48, 24, 3, h) + conv(96, 24, 3, h)
             + conv(96, 48, 3, q) + conv(192, 48, 3, q)
             + 5 * conv(192, 96, 3, q))
    pm = (conv(48, 3, 5, s) + conv(48, 24, 3, h) + conv(96, 24, 3, h)
          + conv(192, 48, 3, q) + 2 * conv(192, 96, 3, q)
          + 2 * conv(192, 96, 3, q))
    return 2 * enc(5) + 2 * dec(192) + xconv + pm


def hand_attention(s):
    side = (s // 4 - 4) // 2 + 1
    n, d = side * side, 96 * 16
    return 2 * (2.0 * n * n * d)


@pytest.mark.parametrize("size", [256, 512])
def test_edit_count_matches_hand_count(size):
    assert counts.net_m(size) == hand_net_m(size)
    assert counts.net_g_convs(size) == hand_net_g(size)
    assert counts.attention(size) == hand_attention(size)
    assert counts.edit(size) == (hand_net_m(size) + hand_net_g(size)
                                 + hand_attention(size))


def test_edit_counts_at_the_cells_sizes():
    # 256^2: 95.4 GFLOP of convs and 5.67 of attention; 512^2: 381 + 96.8
    assert counts.edit(256) == pytest.approx(101.03e9, rel=1e-3)
    assert counts.attention(256) == pytest.approx(5.674e9, rel=1e-3)
    assert counts.edit(512) == pytest.approx(478.2e9, rel=1e-3)
    assert counts.attention(512) == pytest.approx(96.79e9, rel=1e-3)


@pytest.mark.parametrize("size", [256, 512])
def test_edit_count_matches_torch_flop_counter(size):
    W = {n: {k: torch.empty(v.shape, device="meta")
             for k, v in weights.make(n, 0, "cpu", {}).items()}
         for n in "MG"}
    img = torch.zeros(1, size, size, 3, dtype=torch.uint8, device="meta")
    with FlopCounterMode(display=False) as fc:
        edit.edit(W, img, img[..., :1])
    assert fc.get_total_flops() == counts.edit(size)


@pytest.mark.parametrize("size", [256, 512])
def test_netd_and_vgg_counts_match_torch_flop_counter(size):
    D = {k: torch.empty(v.shape, device="meta")
         for k, v in weights.make("D", 0, "cpu", {}).items()}
    vgg = [(torch.empty(w.shape, device="meta"),
            torch.empty(b.shape, device="meta"))
           for w, b in weights.vgg(0, "cpu")]
    x = torch.zeros(1, 3, size, size, device="meta")
    one = lambda t: t
    with FlopCounterMode(display=False) as fc:
        nets.net_d(D, x, x[:, :1], x, one)
    d = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        nets.vgg_features(vgg, x, one)
    # and the power iteration's matrix-vector products, three per layer
    power = sum(3 * 2.0 * cout * cin * 25 for _n, cin, cout in nets.D_LAYERS)
    assert 0 <= d - counts.net_d(size) <= power + 1e5
    assert fc.get_total_flops() == counts.vgg(size)


def test_train_step_count():
    for size in (256, 512):
        assert counts.train_step_per_image(size) == (
            4 * counts.edit(size) + 7 * counts.net_d(size)
            + 3 * counts.vgg(size))
    assert counts.train_step_per_image(512) == pytest.approx(2616e9,
                                                             rel=1e-3)


def test_attention_roofline_counts():
    n, d = counts.attention_grid(512)
    assert (n, d) == (3969, 1536)
    flops, nbytes = counts.attention_forward(2, n, n, d, [n, 0], 2, False)
    assert flops == 2.0 * n * d * (2 * n) + 2.0 * n * d * n
    assert nbytes == 2 * n * d * 2 + 2 * n * 4 + 2 * d * 4 + 2 * n * d * 4
    flops, _ = counts.attention_backward(1, n, n, d, [n], 2)
    assert flops == 2.0 * n * d * 4 * n


def test_peaks_by_card_name():
    assert counts.peaks("NVIDIA H100 80GB HBM3")["bfloat16"] == 989e12
    assert counts.peaks("NVIDIA H100 PCIe")["bytes"] == 2.0e12
