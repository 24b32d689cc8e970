"""G+D training steps fed from a seeded pool of batches in pinned memory.

The cell's workload file gives the batch (``batch``), the number of
distinct batches in the pool (``pool``), the steps a traced run profiles
(``trace_steps``) and the step it starts at (``trace_from``).

Set-up builds the training state as the train CLI does (netM, netG and
netD of ``train/trainer.py`` with its TTUR Adam pair), loads the
benchmark's seeded weights into it and makes the pool on the device: each
row a photo-like image with a partial sketch, an edge map of more strokes
and two rectangles (the inpainting and context masks), held in the
compact protocol (uint8 image, bool masks) in pinned host memory and
copied in for each step. The branch flags (G, D) of every step are drawn
from the seed. Set-up then drives that state through its first three
steps, through the same call and feed as the window, and reads what the
check compares: each step's losses, the first gradient of every leaf
(from Adam's first moment after one step) and every leaf's change over
the three. The window runs further steps until its time is up, the
device synchronised at both ends.

The check runs the plain reference's three steps (``reference/train.py``)
from the same weights, batches and flags, and compares:

- ``grad_gap_x_bf16``: the gap between the two first-gradient norms of a
  leaf, over the reference's norm of that leaf or of the median leaf,
  whichever is larger, for the median leaf, in units of the same gap of
  the reference in plain bfloat16 arithmetic (how far bfloat16 lands
  varies between weight seeds; the ratio takes that out);
- ``grad_gap_worst``: the same gap for the worst leaf, not in units;
- ``change_gap_worst``: the same for each leaf's change over the three
  steps, the worst leaf, leaving out leaves whose reference gradient is
  under a thousandth of the median leaf's (they move by Adam's rounding
  alone);
- ``mask_rms_lsb_x_bf16``: the first step's soft mask against the
  reference's, RMS, in units of the same distance of plain bfloat16;
- ``hard_mismatch_x_bf16``: pixels of that mask on the other side of the
  threshold from the reference's, in units of plain bfloat16's;
- ``threshold_mismatch_px``: pixels where a hard mask the program fed netG
  under flag 2 is not its soft mask's side of the threshold.

Under flag 2 a few mask pixels that cross 0.5 move netG's output far, so
the reference follows the program's hard masks (read by hooks on netM's
output and netG's inputs during the first steps), and the last three
numbers check the mask and the threshold on their own.

The losses are not compared: the float8 control moves the first step's
less than three times as far as sound runs do, and the later steps
amplify rounding, in plain bfloat16 and even in the program in float32
(PERF.md has the readings). They (``loss_gap``, ``loss_gap_3``), the
median leaf's change and plain bfloat16's reading of every number are
reported beside the compared numbers.
"""

from __future__ import annotations

import copy
import gc
import math
import statistics
import time

import torch

from benchmark import inputs, weights
from benchmark.reference import train as ref_train
from benchmark.reference.precision import BF16, FP8

CHECK_STEPS = 3


class Driver:
    def __init__(self, cell):
        self.cell = cell
        self.cfg, self.wl = cell.config, cell.workload
        self.size = self.cfg["resolution"]
        self.dev = cell.device
        self.B = self.wl["batch"]

    def hyper(self) -> dict:
        return {k: self.cfg[k] for k in (
            "lr", "beta1", "beta2", "lambda_vgg", "lambda_l1",
            "lambda_l1_mask", "mask_threshold")}

    def weights(self):
        seed, gains = self.cell.seed, self.cfg["gains"]
        return ({n: weights.make(n, seed, self.dev, gains) for n in "MGD"},
                weights.vgg(seed, self.dev))

    # --- set-up -------------------------------------------------------
    def setup(self, tracer=None):
        phases = self.cell.phases
        self.make_pool()
        phases.mark("batches")
        self.tracer = tracer
        if self.cell.program == "control":
            self.first = self.reference(FP8)
            self.first["threshold_mismatch_px"] = 0
            self.next = CHECK_STEPS
            return
        from sketchedit_tpu_torch.device import set_precision
        from sketchedit_tpu_torch.models.deepfill_c2 import (
            DeepFillC2Generator, DeepFillConfig)
        from sketchedit_tpu_torch.models.discriminator import Discriminator
        from sketchedit_tpu_torch.models.md_generator import MDGenerator
        from sketchedit_tpu_torch.ops import attention_cuda
        from sketchedit_tpu_torch.train import trainer as tr
        from benchmark.trace import AttentionLog

        cfg = self.cfg
        tc = tr.TrainConfig(
            netg=DeepFillConfig(use_cam=cfg["use_cam"],
                                pool_type=cfg["pool_type"],
                                joint_train_inp=cfg["joint_train_inp"]),
            gan_mode="hinge", lambda_l1=cfg["lambda_l1"],
            lambda_l1_mask=cfg["lambda_l1_mask"],
            lambda_vgg=cfg["lambda_vgg"], no_vgg_loss=False,
            lr=cfg["lr"], beta1=cfg["beta1"], beta2=cfg["beta2"],
            mask_threshold=cfg["mask_threshold"],
            precision=None if cfg["tf32"] else "highest",
            compute_dtype=cfg["compute_dtype"])
        set_precision(tc.precision)
        self.tr, self.tc = tr, tc
        nets = {"M": MDGenerator(device=self.dev),
                "G": DeepFillC2Generator(tc.netg, device=self.dev),
                "D": Discriminator(device=self.dev)}
        phases.mark("program")
        W, self.vgg = self.weights()
        for n, net in nets.items():
            net.load_state_dict(W[n])
        del W
        opt_g, opt_d = tr.make_optimizers(tc, nets)
        self.state = tr.TrainState(nets=nets, opt_g=opt_g, opt_d=opt_d,
                                   flag_rng=torch.Generator())
        self.log = AttentionLog()
        if tracer is not None:
            self.log.install(attention_cuda)
        phases.mark("weights")
        self.first = self.first_steps()
        self.next = CHECK_STEPS
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        phases.mark("first_steps")

    def make_pool(self):
        wl, size, dev = self.wl, self.size, self.dev
        g = weights.generator(self.cell.seed, "batches", dev)
        n = wl["pool"] * self.B
        rows = {
            "image": inputs.photo_like(g, n, size, dev),
            "mask": inputs.strokes(g, n, size, dev, *wl["strokes"]) > 0,
            "edgegt": inputs.strokes(g, n, size, dev, *wl["edges"]) > 0,
            "random_mask": inputs.rectangles(g, n, size, dev),
            "random_mask2": inputs.rectangles(g, n, size, dev)}
        pin = dev.type == "cuda"
        self.pool = []
        for i in range(wl["pool"]):
            batch = {}
            for k, v in rows.items():
                host = v[i * self.B:(i + 1) * self.B].cpu()
                batch[k] = host.pin_memory() if pin else host
            self.pool.append(batch)
        del rows
        low = 0 if self.cfg["joint_train_inp"] else 1
        fg = torch.Generator().manual_seed(weights.subseed(self.cell.seed,
                                                           "flags"))
        self.flags = [tuple(f) for f in torch.randint(
            low, 3, (100000, 2), generator=fg).tolist()]

    def leaves(self):
        return {f"{n}.{k}": p for n in "MGD"
                for k, p in self.state.nets[n].named_parameters()}

    def step(self, i):
        host = self.pool[i % len(self.pool)]
        batch = {k: v.to(self.dev, non_blocking=True)
                 for k, v in host.items()}
        if self.cell.fault == "half_batch":
            batch = {k: v[:self.B // 2] for k, v in batch.items()}
        flag_g, flag_d = self.flags[i]
        if self.cell.fault == "unchanged":
            saved = copy.deepcopy((self.state.nets, self.state.opt_g.state_dict(),
                                   self.state.opt_d.state_dict()))
        _, metrics = self.tr.train_step(self.state, batch, flag_g, flag_d,
                                        self.tc, vgg_params=self.vgg)
        if self.cell.fault == "unchanged":
            nets, sg, sd = saved
            for n, net in nets.items():
                self.state.nets[n].load_state_dict(net.state_dict())
            self.state.opt_g.load_state_dict(sg)
            self.state.opt_d.load_state_dict(sd)
        return metrics

    def first_steps(self) -> dict:
        """The first steps, and what the check compares: losses, first
        gradients (from Adam's first moment), changes; and, read by hooks
        on netM's output and netG's inputs, the first soft mask and the hard
        mask of every call under flag 2, which the reference follows."""
        leaves = self.leaves()
        start = {k: p.detach().clone() for k, p in leaves.items()}
        out = {"losses": [], "grad": {}, "hard": []}
        calls = []
        hooks = [
            self.state.nets["M"].register_forward_hook(
                lambda _m, _a, o: calls.append([o[0].detach()])),
            self.state.nets["G"].register_forward_pre_hook(
                lambda _m, a: calls[-1].append(a[2].detach()))]
        beta1, thr = self.cfg["beta1"], self.cfg["mask_threshold"]
        mismatch = 0
        try:
            for i in range(CHECK_STEPS):
                m = self.step(i)
                out["losses"].append((m["G_total"].item(),
                                      (m["D_Fake"] + m["D_real"]).item()))
                if i == 0:
                    out["soft"] = calls[0][0]
                    for k, p in leaves.items():
                        opt = (self.state.opt_d if k.startswith("D.")
                               else self.state.opt_g)
                        avg = opt.state.get(p, {}).get("exp_avg")
                        out["grad"][k] = (0.0 if avg is None
                                          else avg.norm().item() / (1 - beta1))
                for flag, (soft, hard) in zip(self.flags[i], calls[-2:]):
                    if flag == 2:
                        mismatch += int(((soft > thr) != (hard > 0.5)).sum())
                    out["hard"].append(hard if flag == 2 else None)
        finally:
            for h in hooks:
                h.remove()
        out["threshold_mismatch_px"] = mismatch
        out["change"] = {k: (p.detach() - start[k]).norm().item()
                         for k, p in leaves.items()}
        return out

    # --- the window ---------------------------------------------------
    def window(self, seconds: float) -> dict:
        sync = (torch.cuda.synchronize if self.dev.type == "cuda"
                else (lambda: None))
        wl, tracer = self.wl, self.tracer
        if self.cell.program == "control":
            return {"attempted": 0, "failed": 0, "seconds": seconds,
                    "elapsed_s": 0.0, "e2e": {}, "layers": {}}
        trace_from, trace_steps = wl["trace_from"], wl["trace_steps"]
        steps = failed = 0
        traced = 0
        metrics = None
        sync()
        start = time.perf_counter()
        end = start + seconds
        while time.perf_counter() < end:
            if tracer is not None and steps == trace_from:
                tracer.start()
                self.log.active = True
            try:
                if self.log.active:
                    with torch.profiler.record_function("bench:train_step"):
                        metrics = self.step(self.next)
                else:
                    metrics = self.step(self.next)
            except RuntimeError:
                failed += 1
                break
            self.next += 1
            steps += 1
            if tracer is not None and self.log.active and \
                    steps == trace_from + trace_steps:
                self.log.active = False
                tracer.stop()
                traced = trace_steps
        if tracer is not None and self.log.active:
            self.log.active = False
            tracer.stop()
            traced = steps - trace_from
        sync()
        elapsed = time.perf_counter() - start
        if metrics is not None and not math.isfinite(
                metrics["G_total"].item()):
            failed += 1
        return {
            "attempted": steps + failed, "failed": failed,
            "seconds": seconds, "elapsed_s": elapsed,
            "e2e": {"train_img_per_s": steps * self.B / elapsed},
            "layers": {
                "images": steps * self.B, "window_s": elapsed,
                "steps": steps, "slice_steps": traced,
                "slice_images": traced * self.B,
                "attention": self.log.calls if hasattr(self, "log") else [],
                "flops_per_image_key": "train",
            },
        }

    def release(self):
        for name in ("state", "vgg", "tr", "tc"):
            self.__dict__.pop(name, None)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # --- the check ----------------------------------------------------
    def check(self) -> dict:
        hard = self.first["hard"]
        return judge(self.first, self.reference(hard=hard),
                     self.reference(BF16, hard=hard),
                     self.cfg["mask_threshold"])

    def reference(self, q=None, hard=None) -> dict:
        """The reference's first steps, following ``hard`` under flag 2;
        with ``q``, in that lower precision (the control)."""
        W, vgg = self.weights()
        batches = [{k: v.to(self.dev) for k, v in self.pool[i].items()}
                   for i in range(CHECK_STEPS)]
        kw = {} if q is None else {"q": q}
        return ref_train.train_steps(W, vgg, batches,
                                     self.flags[:CHECK_STEPS], self.hyper(),
                                     hard=hard, **kw)


def _gaps(prog: dict, ref: dict, threshold: float) -> dict:
    def rel(p, r):
        return abs(p - r) / max(abs(r), 1e-12)

    steps = [max(rel(p, r) for p, r in zip(ps, rs))
             for ps, rs in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not steps:
        steps = [1e30]
    med_g = statistics.median(ref["grad"].values())
    grads = sorted((abs(prog["grad"].get(k, 0.0) - r) / max(r, med_g), k)
                   for k, r in ref["grad"].items())
    moved = [k for k, r in ref["grad"].items() if r >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][k] for k in moved)
    changes = sorted((abs(prog["change"].get(k, 0.0) - ref["change"][k])
                      / max(ref["change"][k], med_c), k) for k in moved)
    rows = min(len(prog["soft"]), len(ref["soft"]))
    p_soft = prog["soft"][:rows].float()
    r_soft = ref["soft"][:rows].float()
    soft = (p_soft - r_soft).pow(2).mean()
    flips = int(((p_soft > threshold) != (r_soft > threshold)).sum())
    return {"loss_gap": steps[0],
            "grad_gap": statistics.median(g for g, _ in grads),
            "change_gap": statistics.median(c for c, _ in changes),
            "mask_rms_lsb": 255.0 * soft.sqrt().item(),
            "hard_mismatch_px": flips,
            "hard_mismatch_pct": 100.0 * flips / p_soft.numel(),
            "loss_gap_3": max(steps),
            "grad_gap_worst": grads[-1][0], "grad_worst_leaf": grads[-1][1],
            "change_gap_worst": changes[-1][0],
            "change_worst_leaf": changes[-1][1]}


def judge(prog: dict, ref: dict, low: dict, threshold: float) -> dict:
    """``prog``, ``ref``, ``low``: the first steps of the program, of the
    reference following its hard masks, and of the same reference in plain
    bfloat16 arithmetic. ``loss_gap``: the first step's generator and
    discriminator losses, the larger gap relative to the reference's
    (``loss_gap_3``: the worst of the three steps);
    ``grad_gap``: each leaf's gap between the two first-gradient norms
    over the reference's norm of that leaf or of the median leaf,
    whichever is larger, for the median leaf (``grad_gap_worst``: for the
    worst leaf, named in ``grad_worst_leaf``); ``change_gap`` and
    ``change_gap_worst``: the same for each leaf's change over the steps,
    leaves whose reference gradient is under a thousandth of the median
    leaf's left out (they move by Adam's rounding alone);
    ``mask_rms_lsb``: the first soft mask against the reference's, RMS,
    in uint8 units; ``hard_mismatch_px`` and ``_pct``: its pixels on the
    other side of the threshold from the reference's;
    ``threshold_mismatch_px``: pixels where a hard mask under flag 2 is not
    the program's soft mask's side of the threshold. ``<key>_bf16`` is
    plain bfloat16's reading of a number, ``<key>_x_bf16`` the program's
    over it."""
    out = _gaps(prog, ref, threshold)
    base = _gaps(low, ref, threshold)
    for key in ("grad_gap", "mask_rms_lsb", "change_gap_worst",
                "grad_gap_worst"):
        out[f"{key}_x_bf16"] = out[key] / max(base[key], 1e-30)
    out["hard_mismatch_x_bf16"] = (out["hard_mismatch_px"]
                                   / max(base["hard_mismatch_px"], 1))
    for key, value in base.items():
        out[f"{key}_bf16"] = value
    out["threshold_mismatch_px"] = prog["threshold_mismatch_px"]
    return out
