"""Every kernel launch of ``ops/attention_cuda.py`` runs with its tensors'
device current.

A C launch runs on the calling thread's current CUDA device, whatever
device its pointers and stream belong to, so the launch helpers enter
``torch.cuda.device(Q.device)`` around it. Here, without a card, the
kernels, the forwards' scratch size, ``torch.cuda.device`` and
``torch.cuda.current_stream`` are stubs: the helpers get tensors that report ``cuda:1`` and every stub
launch records which device was current when it was called.
"""

import contextlib

import pytest
import torch

from sketchedit_tpu_torch.ops import attention_cuda


class _OnCuda1:
    """A CPU tensor that reports ``cuda:1``: the launch helpers read only
    its shape, dtype, device and data pointer."""

    device = torch.device("cuda", 1)

    def __init__(self, *shape):
        self._t = torch.zeros(*shape)

    shape = property(lambda self: self._t.shape)
    dtype = property(lambda self: self._t.dtype)

    def data_ptr(self):
        return self._t.data_ptr()


@pytest.fixture
def stub_launches(monkeypatch):
    """(launches, current): the stub kernels append (entry point, current
    device index at the call, stream's device index); ``current`` holds the
    current device index, 0 outside any ``torch.cuda.device`` block."""
    current = [0]
    launches = []
    streams = []

    @contextlib.contextmanager
    def device(d):
        before = current[0]
        current[0] = torch.device(d).index
        try:
            yield
        finally:
            current[0] = before

    class _Stream:
        cuda_stream = 0

    def current_stream(d=None):
        streams.append(torch.device(d).index)
        return _Stream()

    def kernel(name="fwd"):
        def launch(*args):
            launches.append((name, current[0], streams[-1]))
            return 0
        return launch, lambda rc: b"stub"

    real_empty = torch.empty
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: real_empty(*a, **k))
    monkeypatch.setattr(attention_cuda, "_kernel", kernel)
    # the wgmma forwards' scratch size comes from the built library: one
    # 64-row chunk of a byte here
    monkeypatch.setattr(attention_cuda, "fwd_scratch", lambda *a, **k: (1, 64))
    return launches, current


def test_every_launch_runs_inside_its_tensors_device(stub_launches):
    launches, current = stub_launches
    B, N, D = 1, 4, 8
    Q, K, V = (_OnCuda1(B, N, D) for _ in range(3))
    keep, lse = _OnCuda1(B, N), _OnCuda1(B, N)
    kscale = _OnCuda1(B, D)
    forwards = ("fwd", "fwd_dsplit", "fwd_shared")
    for name in forwards:
        out, got_lse = attention_cuda._forward_on_device(
            name, Q, K, V, keep, 10.0, True, torch.float32, kscale)
        assert out.shape == (B, N, D) and got_lse.shape == (B, N)
    # the C signatures' pointer counts
    backwards = (("dq", 10), ("dkdv", 11), ("bwd", 12), ("dv", 7), ("dk", 9))
    for name, n_ptrs in backwards:
        attention_cuda._launch_bwd(name, Q, K, (Q,) * n_ptrs, 10.0)
    names = [name for name in forwards] + [name for name, _ in backwards]
    assert launches == [(name, 1, 1) for name in names]
    assert current[0] == 0          # the caller's device is current again


def test_a_refused_launch_still_restores_the_device(stub_launches,
                                                    monkeypatch):
    _, current = stub_launches

    def refused(name="fwd"):
        return (lambda *args: 1), (lambda rc: b"too much shared memory")

    monkeypatch.setattr(attention_cuda, "_kernel", refused)
    Q = _OnCuda1(1, 4, 8)
    with pytest.raises(RuntimeError, match="too much shared memory"):
        attention_cuda._launch_bwd("dkdv", Q, Q, (Q,) * 11, 10.0, (64,))
    assert current[0] == 0
