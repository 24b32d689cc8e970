"""Device time per spec row of the port's nets, from a torch.profiler run.

    from profile_rows_torch import RowRanges, row_times, category

``RowRanges(nets)`` wraps, for as long as it is entered, every layer's
``forward`` of the given nets ({'M': netM, 'G': netG, ...}) and the packed
functions that the nets call (``ops/packed_tail.py``: the front pair, the
three- and five-layer tails) in a ``record_function`` range named
``row:<net>.<layer>`` (a packed group: ``row:<net>.<first>+...+<last>``).
These are hooks that a profiling script installs; the nets' own code
carries none. ``row_times(events)`` then sums, per row, the device time of
the kernels launched under the row's range (the forward, its gating
included) and of the autograd nodes that the row's forward ops recorded
(the backward, matched by sequence number). ``category`` files a kernel
by its name: the attention forward, the attention backward (every route's
kernels in one category: the joint backward runs dQ's product kernel
beside the fused dK/dV's, so a kernel's name does not tell its route), the
optimizer, cuDNN's convolutions (its FFT kernels among them) and
everything else.
"""

from __future__ import annotations

import torch
from torch.autograd import DeviceType

from sketchedit_tpu_torch.models import md_generator

PACKED = ("packed_encoder_front", "packed_decoder_tail",
          "packed_decoder_tail5")
ROW = "row:"
BACKWARD = "autograd::engine::evaluate_function:"


def category(name: str) -> str:
    low = name.lower()
    for kernel, cat in (("ca_fwd", "attention_fwd"),
                        ("ca_dq_", "attention_bwd"),
                        ("ca_dkdv_", "attention_bwd")):
        if kernel in low:
            return cat
    if "multi_tensor" in low or "adam" in low:
        return "optimizer"
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "winograd",
                              "fprop", "dgrad", "wgrad", "gemm", "sm90",
                              "fft", "complex", "flip_filter")):
        return "conv"
    return "other"


class RowRanges:
    """Context manager: profiler ranges around every spec row of ``nets``
    ({label: module}) while entered."""

    def __init__(self, nets: dict):
        self.nets = nets
        self.names = {id(layer): (label, name)
                      for label, net in nets.items()
                      for name, layer in net.named_children()}
        self.saved = []

    def _wrap_layer(self, layer, row):
        forward = layer.forward

        def ranged(*args, **kwargs):
            with torch.profiler.record_function(ROW + row):
                return forward(*args, **kwargs)
        layer.forward = ranged
        self.saved.append((layer, "forward", None))

    def _wrap_packed(self, fname):
        fn = getattr(md_generator, fname)

        def ranged(*layers_and_x):
            label, first = self.names[id(layers_and_x[0])]
            rest = [self.names[id(layer)][1] for layer in layers_and_x[1:-1]]
            row = f"{label}." + "+".join([first, *rest])
            with torch.profiler.record_function(ROW + row):
                return fn(*layers_and_x)
        setattr(md_generator, fname, ranged)
        self.saved.append((md_generator, fname, fn))

    def __enter__(self):
        for label, net in self.nets.items():
            for name, layer in net.named_children():
                self._wrap_layer(layer, f"{label}.{name}")
        for fname in PACKED:
            self._wrap_packed(fname)
        return self

    def __exit__(self, *exc):
        for owner, attr, value in reversed(self.saved):
            if value is None:
                del owner.forward        # back to the class's forward
            else:
                setattr(owner, attr, value)
        self.saved.clear()


def _descendants(evt):
    stack = list(evt.cpu_children)
    while stack:
        e = stack.pop()
        yield e
        stack.extend(e.cpu_children)


def row_times(events, reps: int = 1, attr: str = "device_time_total"):
    """{row: ms} forward and {row: ms} backward per call from a profiler's
    ``events()``: ``attr`` of each row range (its kernels, children
    included), and of every autograd node evaluation whose sequence number
    one of the row's forward ops recorded."""
    fwd, bwd, by_seq = {}, {}, {}
    for evt in events:
        if evt.device_type == DeviceType.CPU and evt.name.startswith(ROW):
            row = evt.name[len(ROW):]
            fwd[row] = fwd.get(row, 0.0) + getattr(evt, attr) / 1e3 / reps
            for child in _descendants(evt):
                if child.sequence_nr >= 0:
                    by_seq[child.sequence_nr] = row
    for evt in events:
        if evt.name.startswith(BACKWARD) and evt.sequence_nr in by_seq:
            row = by_seq[evt.sequence_nr]
            bwd[row] = bwd.get(row, 0.0) + getattr(evt, attr) / 1e3 / reps
    return fwd, bwd


def kernel_times(events, reps: int = 1):
    """[(kernel name, ms per call)] of the device kernels, and the number
    of launches per call. The device's copies of ``record_function``
    ranges (the rows, ``Optimizer.step``) are not kernels: left out."""
    top, launches = {}, 0
    for evt in events:
        if evt.device_type == DeviceType.CUDA and not (
                evt.is_user_annotation or evt.name.startswith(ROW)):
            ms = evt.time_range.elapsed_us() / 1e3 / reps
            top[evt.name] = top.get(evt.name, 0.0) + ms
            launches += 1
    return sorted(top.items(), key=lambda kv: -kv[1]), launches / reps
