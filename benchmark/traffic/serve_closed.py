"""Closed-loop serving traffic through the program's batching executor.

The cell's workload file gives ``clients`` (edits in flight), ``max_batch``
and ``max_wait_ms`` of ``server/executor.py::BatchingExecutor``, the size
of the seeded pool of distinct requests (``pool``), the strokes per sketch
(``strokes``: [least, most]), the batches a traced run profiles
(``trace_batches``) and how many answers the check draws (``sample``).

Set-up builds the served pipeline as the serve CLI does (``runner.
EditPipeline`` over ``models/editline2.py`` in the configuration's dtype and
TF32 setting), loads the benchmark's seeded weights into it, makes the
request pool on the device, and warms every batch bucket of the executor.
The window keeps ``clients`` edits in flight from one load thread: each
answer's arrival sends that client's next edit, a photo-like image with a
partial sketch drawn from the pool in a seeded order. A request's latency
runs from ``submit`` to its answer; the rate and the tail take every edit
answered inside the window.

The check draws a seeded sample of the answered edits (reservoir
sampling) and holds each to the plain reference (``reference/edit.py``):

- ``mask_rms_x_bf16``: the served masks' RMS distance from netM's soft
  masks, over every sampled pixel, in units of the distance that the same
  function evaluated in plain bfloat16 arithmetic (both operands of every
  product rounded to bfloat16, the output rounded as served) lands from it;
- ``threshold_mismatch_px``: pixels where the hard mask netG was fed
  differs from the served mask's side of 0.5 (the served value 128 is
  either side of it and is skipped), all requests;
- ``hard_mismatch_x_bf16``: pixels where the hard mask netG was fed
  differs from the reference's own (its soft mask thresholded at 0.5), in
  units of the pixels where plain bfloat16's soft mask thresholded does;
- ``edit_rms_x_bf16``: the same for the served composites against the
  reference's netG fill under that same hard mask, composited with the
  served mask.

How far bfloat16 lands from float32 varies threefold between requests and
weight seeds (a few inputs sit where the nets amplify rounding); the ratio
takes that out, as plain bfloat16 code moves with it. The raw distances
(``mask_rms_lsb``, ``edit_rms_lsb``, uint8 units) and the worst request's
are reported beside them for calibration (PERF.md says why they are not
compared).

netG's output moves by tens of units when a few mask pixels cross 0.5, so
the reference follows the program from the hard mask it fed netG (read by
a hook on netG's inputs), and the first three numbers check the mask and
the threshold on their own: the hard mask against the served soft mask
and against the reference's own.
"""

from __future__ import annotations

import gc
import queue
import random
import threading
import time

import numpy as np
import torch

from benchmark import inputs, weights
from benchmark.reference import edit as ref_edit
from benchmark.reference.precision import BF16, FP8
from benchmark.trace import AttentionLog


class _Batch(np.ndarray):
    """A batch's output array that tells its rows which batch they are."""

    def __array_finalize__(self, obj):
        self.batch = getattr(obj, "batch", None)


class Served:
    """The pipeline the executor calls: times each call (the benchmark's
    span), keeps the hard mask netG read for rows the check asks for, and
    profiles the traced slice of batches."""

    def __init__(self, pipeline, netg, tracer=None, log=None,
                 trace_batches=0, trace_after_s=0.0):
        self.pipeline = pipeline
        self.calls = []               # (batch, start, seconds, CPU seconds)
        self.ring = {}                # batch -> hard mask (device)
        self.wanted = queue.SimpleQueue()
        self.kept = {}                # (batch, row) -> hard mask row
        self.tracer, self.log = tracer, log
        self.trace_batches = trace_batches
        self.trace_after = None
        self.trace_after_s = trace_after_s
        self.traced = []              # batch numbers in the slice
        self.control = None           # the load thread's queue
        self._hard = None
        netg.register_forward_pre_hook(self._hook)

    def _hook(self, _module, args):
        self._hard = args[2]

    def arm(self, t0):
        self.trace_after = t0 + self.trace_after_s

    def _keep_wanted(self):
        while True:
            try:
                batch, row = self.wanted.get_nowait()
            except queue.Empty:
                return
            hard = self.ring.get(batch)
            if hard is not None:
                self.kept[(batch, row)] = hard[row].clone()

    def _main_thread(self, what):
        """Have the load thread start or stop the profiler (it has to run
        where the profiler was set up) while this batch waits."""
        ready = threading.Event()
        self.control.put((what, ready))
        ready.wait()

    def __call__(self, images, sketches):
        self._keep_wanted()
        n = len(self.calls)
        start = time.perf_counter()
        cpu = time.thread_time()
        tracing = (self.tracer is not None and self.trace_after is not None
                   and len(self.traced) < self.trace_batches
                   and start >= self.trace_after)
        if tracing and not self.traced:
            self._main_thread("start")
            start = time.perf_counter()
        if tracing:
            with torch.profiler.record_function("bench:pipeline"):
                composed, mask = self.pipeline(images, sketches)
        else:
            composed, mask = self.pipeline(images, sketches)
        seconds = time.perf_counter() - start
        cpu = time.thread_time() - cpu
        if tracing:
            self.traced.append(n)
            if len(self.traced) == self.trace_batches:
                self._main_thread("stop")
        self.calls.append((n, start, seconds, cpu))
        self.ring[n] = self._hard
        self.ring.pop(n - 4, None)
        composed = composed.view(_Batch)
        composed.batch = n
        return composed, mask

    def finish(self):
        """After the dispatcher has stopped: keep what was asked for last,
        and end a slice the window cut short."""
        self._keep_wanted()
        if self.traced and len(self.traced) < self.trace_batches:
            self.log.active = False
            self.tracer.stop()
        self.ring.clear()


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.cfg, self.wl = cell.config, cell.workload
        self.size = self.cfg["resolution"]
        self.dev = cell.device

    # --- set-up -------------------------------------------------------
    def setup(self, tracer=None):
        from sketchedit_tpu_torch.device import set_precision
        from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
        from sketchedit_tpu_torch.models.editline2 import (
            EditLine2, EditLine2Config)
        from sketchedit_tpu_torch.ops import attention_cuda
        from sketchedit_tpu_torch.runner import EditPipeline
        from sketchedit_tpu_torch.server.executor import BatchingExecutor

        cfg, wl, seed = self.cfg, self.wl, self.cell.seed
        phases = self.cell.phases
        config = EditLine2Config(
            netg=DeepFillConfig(use_cam=cfg["use_cam"],
                                pool_type=cfg["pool_type"],
                                joint_train_inp=cfg["joint_train_inp"]),
            mask_threshold=cfg["mask_threshold"],
            precision=None if cfg["tf32"] else "highest",
            compute_dtype=cfg["compute_dtype"])
        set_precision(config.precision)
        model = EditLine2(config, device=self.dev)
        phases.mark("program")
        for net in "MG":
            getattr(model, f"net{net}").load_state_dict(
                weights.make(net, seed, self.dev, cfg["gains"]))
        model.eval()
        phases.mark("weights")
        pipeline = EditPipeline(model=model, config=config, device=self.dev)
        if self.cell.program == "control":
            pipeline = ControlPipeline(self, FP8)
        if self.cell.fault == "altered_answer":
            pipeline = AlteredAnswer(pipeline)
        self.log = AttentionLog()
        if tracer is not None:
            self.log.install(attention_cuda)
        self.served = Served(pipeline, model.netG, tracer, self.log,
                             wl["trace_batches"], wl["trace_after_s"])

        g = weights.generator(seed, "requests", self.dev)
        n = wl["pool"]
        images = inputs.photo_like(g, n, self.size, self.dev)
        sketches = inputs.strokes(g, n, self.size, self.dev, *wl["strokes"])
        self.images = images.cpu().numpy()
        self.sketches = sketches.cpu().numpy()
        del images, sketches
        self.order = np.random.default_rng(
            weights.subseed(seed, "order")).permutation(n)
        phases.mark("requests")
        self.executor = BatchingExecutor(
            self.served, max_batch=wl["max_batch"],
            max_wait_ms=wl["max_wait_ms"])
        self.executor.warmup((self.size, self.size), timeout=600)
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        phases.mark("warmup")

    # --- the window ---------------------------------------------------
    def window(self, seconds: float) -> dict:
        wl, ex, served = self.wl, self.executor, self.served
        done = queue.SimpleQueue()
        rng = random.Random(weights.subseed(self.cell.seed, "sample"))
        k = wl["sample"]
        reservoir = []
        rows = {}                     # batch -> real rows answered
        n_pool = len(self.order)
        stats0 = ex.stats()

        def submit(seq):
            idx = int(self.order[seq % n_pool])
            t0 = time.perf_counter()
            fut = ex.submit(self.images[idx], self.sketches[idx])
            fut.add_done_callback(
                lambda f: done.put((idx, t0, time.perf_counter(), f)))

        latencies, failed, seq, in_flight, answered = [], 0, 0, 0, 0
        served.control = done
        start = time.perf_counter()
        end = start + seconds
        served.arm(start)
        for _ in range(wl["clients"]):
            submit(seq)
            seq += 1
            in_flight += 1
        while in_flight:
            item = done.get()
            if len(item) == 2:              # the dispatcher asks for the
                what, ready = item          # profiler
                if what == "start":
                    self.served.tracer.start()
                    self.log.active = True
                else:
                    self.log.active = False
                    self.served.tracer.stop()
                ready.set()
                continue
            idx, t0, t1, fut = item
            in_flight -= 1
            if fut.exception() is not None:
                failed += 1
            else:
                composed, mask = fut.result()
                batch = composed.batch
                rows[batch] = rows.get(batch, 0) + 1
                if t1 <= end:
                    latencies.append(t1 - t0)
                    answered += 1
                    slot = (answered - 1 if answered <= k
                            else rng.randrange(answered))
                    if slot < k:
                        row = (composed.ctypes.data - composed.base.ctypes.data
                               ) // composed.nbytes
                        served.wanted.put((batch, row))
                        entry = (idx, batch, row, np.array(composed),
                                 np.array(mask))
                        if answered <= k:
                            reservoir.append(entry)
                        else:
                            reservoir[slot] = entry
            if time.perf_counter() < end:
                submit(seq)
                seq += 1
                in_flight += 1
        elapsed = time.perf_counter() - start
        stats1 = ex.stats()
        ex.shutdown()
        served.finish()
        self.samples = [(idx, comp, mask, served.kept.get((b, r)))
                        for idx, b, r, comp, mask in reservoir]
        lat_ms = np.sort(np.asarray(latencies) * 1e3)
        p95 = (float(lat_ms[int(np.ceil(0.95 * len(lat_ms))) - 1])
               if len(lat_ms) else None)
        traced = set(served.traced)
        calls = [c for c in served.calls if start <= c[1] <= end]
        return {
            "attempted": answered + failed, "failed": failed,
            "seconds": seconds, "elapsed_s": elapsed,
            "host": {
                # the pipeline call, the dispatcher's CPU time in it, and
                # its whole cycle from one call's start to the next's
                "pipeline_call_ms_median": float(np.median(
                    [c[2] for c in calls]) * 1e3) if calls else None,
                "pipeline_call_cpu_ms_median": float(np.median(
                    [c[3] for c in calls]) * 1e3) if calls else None,
                "batch_cycle_ms_median": float(np.median(np.diff(
                    [c[1] for c in calls])) * 1e3) if len(calls) > 1
                else None},
            "e2e": {"edit_img_per_s": answered / seconds,
                    "edit_p95_ms": p95},
            "layers": {
                "images": answered, "window_s": seconds,
                "max_batch": wl["max_batch"],
                "served": stats1["requests_served"]
                - stats0["requests_served"],
                "batches": stats1["batches_dispatched"]
                - stats0["batches_dispatched"],
                "pipeline_ms": [c[2] * 1e3 for c in served.calls
                                if c[1] >= start],
                "slice_images": sum(rows.get(b, 0) for b in traced),
                "attention": self.log.calls,
                "flops_per_image_key": "edit",
            },
        }

    def release(self):
        del self.executor, self.served
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check ----------------------------------------------------
    def check(self) -> dict:
        W = {n: weights.make(n, self.cell.seed, self.dev, self.cfg["gains"])
             for n in "MG"}
        return judge(W, self.images, self.sketches, self.samples, self.dev,
                     self.wl["check_block"])


def judge(W, images, sketches, samples, device, block: int) -> dict:
    """The numbers over the sampled answers: (pool index, served composite
    (H, W, 3) uint8, served mask (H, W, 1) uint8, hard mask netG read
    (H, W, 1) or None). ``*_rms_lsb`` pool every sampled pixel,
    ``*_worst_lsb`` take the worst request's RMS, ``*_rms_x_bf16`` are
    ``*_rms_lsb`` over plain bfloat16's; ``hard_mismatch_pct`` is the
    share of pixels where the hard mask differs from the reference's own,
    ``hard_mismatch_pct_bf16`` the same of plain bfloat16's soft mask
    thresholded, ``hard_mismatch_x_bf16`` the first over the second."""
    sq = {"mask": 0.0, "edit": 0.0, "mask_bf16": 0.0, "edit_bf16": 0.0}
    count = {"mask": 0, "edit": 0}
    worst = {"mask": 0.0, "edit": 0.0}
    mismatch = 0
    flips = {"prog": 0, "bf16": 0}
    missing = sum(1 for s in samples if s[3] is None)
    for i in range(0, len(samples), block):
        part = [s for s in samples[i:i + block] if s[3] is not None]
        if not part:
            continue
        idx = [s[0] for s in part]
        img = torch.from_numpy(images[idx]).to(device)
        sk = torch.from_numpy(sketches[idx]).to(device)
        comp = torch.from_numpy(np.stack([s[1] for s in part])).to(device)
        mask = torch.from_numpy(np.stack([s[2] for s in part])).to(device)
        hard = torch.stack([torch.as_tensor(s[3]).to(device).reshape(
            mask.shape[1:]) for s in part]).float()
        side = mask != 128
        mismatch += int(((hard > 0.5) != (mask >= 129))[side].sum())
        soft = mask.float() / 255.0
        ref_mask = ref_edit.soft_mask(W, img, sk)
        ref_comp = ref_edit.composite(W, img, sk, hard, soft)
        # the same functions in plain bfloat16 arithmetic, rounded as served
        low_mask = ref_edit.soft_mask(W, img, sk, BF16)
        for key, low, ref in (
                ("mask_bf16", low_mask, ref_mask),
                ("edit_bf16", ref_edit.composite(W, img, sk, hard, soft, BF16),
                 ref_comp)):
            sq[key] += (torch.round(low) - ref).pow(2).sum().item()
        own = ref_mask > 127.5                # the reference's soft > 0.5
        flips["prog"] += int(((hard > 0.5) != own).sum())
        flips["bf16"] += int(((low_mask > 127.5) != own).sum())
        for key, got, ref in (
                ("mask", mask, ref_mask),
                ("edit", comp, ref_comp)):
            err = (got.float() - ref.float()).pow(2)
            sq[key] += err.sum().item()
            count[key] += err.numel()
            worst[key] = max(worst[key],
                             err.mean(dim=(1, 2, 3)).sqrt().max().item())
    out = {"threshold_mismatch_px": mismatch + missing * 10 ** 9}
    pixels = count["mask"]
    for key, name in (("prog", "hard_mismatch_pct"),
                      ("bf16", "hard_mismatch_pct_bf16")):
        out[name] = 100.0 * flips[key] / pixels if pixels else None
    out["hard_mismatch_x_bf16"] = (flips["prog"] / max(flips["bf16"], 1)
                                   if pixels else None)
    for key in ("mask", "edit"):
        out[f"{key}_rms_lsb"] = ((sq[key] / count[key]) ** 0.5
                                 if count[key] else None)
        out[f"{key}_worst_lsb"] = worst[key] if count[key] else None
        out[f"{key}_rms_x_bf16"] = ((sq[key] / sq[f"{key}_bf16"]) ** 0.5
                                    if sq[f"{key}_bf16"] else None)
    return out


class ControlPipeline:
    """The reference in the program's place, in a lower precision: what
    the check must refuse. Sets the hard mask it used where the hook
    expects netG's inputs."""

    def __init__(self, driver, q):
        self.driver, self.q = driver, q
        self.weights = {n: weights.make(n, driver.cell.seed, driver.dev,
                                        driver.cfg["gains"]) for n in "MG"}
        self.hook = None

    def __call__(self, images, sketches):
        dev = self.driver.dev
        comp, mask, hard = ref_edit.edit(
            self.weights, torch.from_numpy(images).to(dev),
            torch.from_numpy(sketches).to(dev), self.q)
        self.driver.served._hard = hard.permute(0, 3, 1, 2)
        return comp.cpu().numpy(), mask.cpu().numpy()


class AlteredAnswer:
    """A fault: the pipeline's first row of every batch of two or more is
    answered with the second row's composite."""

    def __init__(self, pipeline):
        self.pipeline = pipeline

    def __call__(self, images, sketches):
        composed, mask = self.pipeline(images, sketches)
        if len(composed) > 1:
            composed = composed.copy()
            composed[0] = composed[1]
        return composed, mask
