"""The traced slice of a ``--trace 1`` run and what the metrics read from it.

``Tracer`` profiles a slice of the measured window with ``torch.profiler``
(host and device activity), started and stopped with the device
synchronised, on the thread that launches the work, so the slice holds
whole calls. ``Tracer.read`` turns the profile into a ``Trace``: the
device's kernels, copies and fills inside the slice (each kernel filed by
name into conv, attention forward, attention backward, optimizer or
other: a frozen copy of the categorisation the repository's profiling
scripts use), the union of their intervals (``busy_s``), the slice's
length (``window_s``) and the breakdown a result line carries.

Attention calls in the slice are counted by ``AttentionLog``: a wrapper
around the program's ``attention_inputs`` that records each call's shape,
its kept keys per row and whether a backward will follow, so the rooflines
count what these inputs need.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import torch

SLICE = "bench:slice"


def category(name: str) -> str:
    low = name.lower()
    if "ca_fwd" in low:
        return "attention_fwd"
    if "ca_dq_" in low or "ca_dkdv_" in low:
        return "attention_bwd"
    if "multi_tensor" in low or "adam" in low:
        return "optimizer"
    if any(k in low for k in ("conv", "xmma", "implicit", "cudnn", "winograd",
                              "fprop", "dgrad", "wgrad", "gemm", "sm90",
                              "fft", "complex", "flip_filter")):
        return "conv"
    return "other"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int
    category_s: dict
    device_ops: list
    idle_gaps: list


@dataclass
class AttentionCall:
    B: int
    N: int
    P: int
    D: int
    esize: int
    backward: bool
    kept: object                 # (B,) tensor of kept keys; read at the end


@dataclass
class AttentionLog:
    calls: list = field(default_factory=list)
    active: bool = False

    def install(self, attention_cuda):
        """Wrap ``attention_cuda.attention_inputs`` (looked up by name on
        every call of the program's fused attention)."""
        original = attention_cuda.attention_inputs

        def logged(f, b, mask, **kw):
            Q, V, keep, kscale = original(f, b, mask, **kw)
            if self.active:
                grad = torch.is_grad_enabled() and f.requires_grad
                self.calls.append(AttentionCall(
                    B=V.shape[0], N=Q.shape[1], P=V.shape[1], D=V.shape[2],
                    esize=V.element_size(), backward=grad,
                    kept=keep.sum(dim=1)))
            return Q, V, keep, kscale
        attention_cuda.attention_inputs = logged
        return self


class Tracer:
    def __init__(self):
        self.prof = None
        self.span = None

    def warm(self):
        """A short profile of one device op, so the profiler's own start-up
        is paid in set-up."""
        with torch.profiler.profile(activities=self._activities()):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @staticmethod
    def _activities():
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def start(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.start()
        self.span = torch.profiler.record_function(SLICE)
        self.span.__enter__()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.stop()

    def read(self) -> Trace:
        events = self.prof.profiler.kineto_results.events()
        lo = hi = None
        device, host = [], []
        launches = {}
        for e in events:
            name = e.name()
            if name == SLICE and e.device_type() == torch.autograd.DeviceType.CPU:
                lo, hi = e.start_ns(), e.end_ns()
            elif e.device_type() == torch.autograd.DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append((e.start_ns(), e.end_ns(), name,
                                   not name.startswith(("Memcpy", "Memset"))))
            else:
                host.append((e.start_ns(), e.end_ns(), name,
                             e.start_thread_id()))
                if name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                            "cuLaunchKernel", "cuLaunchKernelEx"):
                    tid = e.start_thread_id()
                    launches[tid] = launches.get(tid, 0) + 1
        if lo is None:
            lo = min((d[0] for d in device), default=0)
            hi = max((d[1] for d in device), default=0)
        device = [d for d in device if d[1] > lo and d[0] < hi]
        cats, ops, kernels = {}, {}, 0
        for s, t, name, is_kernel in device:
            dur = (min(t, hi) - max(s, lo)) / 1e9
            ops[name] = ops.get(name, 0.0) + dur
            if is_kernel:
                kernels += 1
                c = category(name)
                cats[c] = cats.get(c, 0.0) + dur
        busy, gaps = _union(sorted((max(s, lo), min(t, hi))
                                   for s, t, _, _ in device), lo, hi)
        thread = max(launches, key=launches.get) if launches else None
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        return Trace(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9,
                     kernels=kernels, category_s=cats,
                     device_ops=[[n[:120], s] for n, s in top],
                     idle_gaps=_label_gaps(gaps, host, thread))


def _union(intervals, lo, hi):
    """Total covered ns, and the idle gaps [(start, end)] in [lo, hi]."""
    covered, gaps, cursor = 0, [], lo
    for s, t in intervals:
        if s > cursor:
            gaps.append((cursor, s))
            cursor = s
        if t > cursor:
            covered += t - cursor
            cursor = t
    if hi > cursor:
        gaps.append((cursor, hi))
    return covered, gaps


def _label_gaps(gaps, host, thread, longest: int = 400):
    """Seconds of the longest idle gaps, summed by what the launching
    thread was doing at each gap's middle (its innermost host event: an op,
    a CUDA runtime call, or the benchmark's span around the program's call,
    ``bench:pipeline`` or ``bench:train_step``, where the program runs
    Python between ops)."""
    host = sorted(h for h in host if thread is None or h[3] == thread)
    starts = [h[0] for h in host]
    out = {}
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:longest]:
        mid = (s + t) // 2
        i = bisect.bisect_right(starts, mid)
        label = "no host op (outside the benchmark's spans)"
        for j in range(i - 1, max(-1, i - 4000), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        out[label] = out.get(label, 0.0) + (t - s) / 1e9
    return [[n[:120], v] for n, v in
            sorted(out.items(), key=lambda kv: -kv[1])[:10]]
