"""What a per-layer metric reads: the traced run's slice and counters.

``Layers`` carries the driver's window data (images and steps in the
window and in the traced slice, the executor's counters, the benchmark's
own spans, the attention calls of the slice) beside the ``Trace`` of the
slice, the configuration, and the published peaks. Each metric under
``metrics/`` is a module with ``read(layers)`` that returns a number, or
None where the run gave it nothing to read.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark import counts


@dataclass
class Layers:
    data: dict              # the driver's "layers" dict
    trace: object           # trace.Trace or None
    config: dict
    peaks: dict

    def get(self, key, default=None):
        return self.data.get(key, default)

    @property
    def peak_flops(self) -> float:
        """The published dense peak of the configuration's arithmetic."""
        if self.config["compute_dtype"] == "bfloat16":
            return self.peaks["bfloat16"]
        return self.peaks["tf32" if self.config["tf32"] else "float32"]

    def device_s(self, category: str):
        if self.trace is None:
            return None
        return self.trace.category_s.get(category)

    def per_slice_image_ms(self, category: str):
        s = self.device_s(category)
        n = self.get("slice_images")
        if s is None or not n:
            return None
        return s * 1e3 / n

    def roofline_pct(self, backward: bool):
        """The attention calls' least time on the card (their operations
        at the peak or their bytes at the bandwidth, whichever is longer)
        over the device time of their kernels, in %."""
        seconds = self.device_s("attention_bwd" if backward
                                else "attention_fwd")
        calls = [c for c in self.get("attention") or []
                 if c.backward or not backward]
        if not seconds or not calls:
            return None
        least = 0.0
        for c in calls:
            kept = [int(k) for k in c.kept.tolist()]
            if backward:
                flops, nbytes = counts.attention_backward(
                    c.B, c.N, c.P, c.D, kept, c.esize)
            else:
                flops, nbytes = counts.attention_forward(
                    c.B, c.N, c.P, c.D, kept, c.esize, c.backward)
            least += max(flops / self.peak_flops,
                         nbytes / self.peaks["bytes"])
        return 100.0 * least / seconds

    def mfu_pct(self):
        """Images per second over the window, times the plain operation
        count of one image's work, over the peak, in %."""
        images, window = self.get("images"), self.get("window_s")
        if not images or not window:
            return None
        size = self.config["resolution"]
        per_image = (counts.edit(size) if self.get("flops_per_image_key")
                     == "edit" else counts.train_step_per_image(size))
        return 100.0 * images / window * per_image / self.peak_flops

    def idle_pct(self):
        if self.trace is None or not self.trace.window_s:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)
