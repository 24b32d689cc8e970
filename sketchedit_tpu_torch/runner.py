"""Pipeline runner: options -> model (checkpoint or fresh init) -> a
callable that edits numpy batches (counterpart of ``sketchedit_tpu/runner.py``).

The callable may be used from any thread (the serving executor calls it
from its dispatcher thread): it makes the pipeline's GPU the thread's
current device, so the kernels launch on that device's current stream;
inference mode is entered per call; the TF32 switches that
``build_pipeline`` sets are process-wide. With ``--data_parallel`` (or
more than one visible card) the pipeline holds one replica of the model
per device and splits every batch over them, each replica in a thread of
its own; ``--attention_impl sharded`` splits the attention's query patches
over the same devices instead, and then the batch is not split.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from sketchedit_tpu_torch.device import resolve_device, set_precision
from sketchedit_tpu_torch.models import editline2
from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
from sketchedit_tpu_torch.models.editline2 import EditLine2, EditLine2Config
from sketchedit_tpu_torch.params import checkpoint as ckpt
from sketchedit_tpu_torch.parallel.mesh import (
    data_parallel_devices, gather, replicate, shard_batch)


def devices_from_opt(opt) -> list:
    """The devices of a multi-device run: on the GPU, the cards of
    ``--gpu_ids`` when it names more than one (ids may repeat), else every
    visible card; on the CPU, ``--data_parallel`` copies of the CPU. The
    first ``--data_parallel`` of them, or all with 0 (``mesh.
    data_parallel_devices``, which raises when more are asked for than
    the list holds)."""
    device = resolve_device(getattr(opt, "device", "cuda"))
    n = getattr(opt, "data_parallel", 0)
    ids = getattr(opt, "gpu_ids", [])
    if device.type == "cpu":
        return data_parallel_devices(n, [device] * max(1, n))
    if len(ids) > 1:
        return data_parallel_devices(n, [torch.device("cuda", i)
                                         for i in ids])
    return data_parallel_devices(n)


def config_from_opt(opt) -> EditLine2Config:
    """The pipeline's configuration; ``--attention_impl sharded`` gets the
    shard devices (``devices_from_opt``), and with one device it warns and
    falls back to 'auto', as the JAX runner does."""
    impl = getattr(opt, "attention_impl", "auto")
    shard_devices = ()
    if impl == "sharded":
        shard_devices = tuple(devices_from_opt(opt))
        if len(shard_devices) < 2:
            print("WARNING: --attention_impl sharded needs >1 device; "
                  "falling back to 'auto'")
            impl, shard_devices = "auto", ()
    return EditLine2Config(
        netg=DeepFillConfig(
            use_cam=getattr(opt, "use_cam", True),
            pool_type=getattr(opt, "pool_type", "max"),
            no_mask_cc=getattr(opt, "no_mask_cc", False),
            no_mask_coarse=getattr(opt, "no_mask_coarse", False),
            joint_train_inp=getattr(opt, "joint_train_inp", True),
            attention_impl=impl,
            attention_devices=shard_devices,
        ),
        precision=(None if getattr(opt, "precision", "highest") == "default"
                   else "highest"),
        compute_dtype=getattr(opt, "compute_dtype", "float32"),
    )


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:       # e.g. a view of a PIL image's buffer
        x = x.copy()
    t = torch.from_numpy(x)
    if device.type == "cuda":
        # pinned host buffer -> asynchronous copy on the current stream
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _on(device: torch.device):
    # the current CUDA device is per thread and starts at 0
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _edit(model, image, sketch):
    """uint8 inputs take ``edit_u8`` (uint8 out); float inputs in [-1, 1]
    take ``edit`` (float32 out)."""
    if image.dtype == torch.uint8:
        return editline2.edit_u8(model, image, sketch)
    composed, mask = editline2.edit(model, image, sketch)
    return composed.float(), mask.float()


@dataclass
class EditPipeline:
    """``model`` on ``device``; with ``replicas``, one (model, device) pair
    per batch shard (the first is ``model`` itself)."""
    model: EditLine2
    config: EditLine2Config
    device: torch.device
    replicas: list = field(default_factory=list)

    def __call__(self, image_nhwc: np.ndarray, sketch_nhw1: np.ndarray):
        """One edit batch -> numpy (composed, soft_mask), NHWC."""
        if len(self.replicas) > 1:
            return self._call_replicas(image_nhwc, sketch_nhw1)
        with _on(self.device), torch.inference_mode():
            image = _to_device(image_nhwc, self.device)
            sketch = _to_device(sketch_nhw1, self.device)
            composed, mask = _edit(self.model, image, sketch)
            return composed.cpu().numpy(), mask.cpu().numpy()

    def _call_replicas(self, image_nhwc, sketch_nhw1):
        """Pad the batch to a multiple of the replicas (repeating its last
        sample), run each shard on its replica in a thread of its own with
        the replica's device current, gather on the host and drop the
        pad."""
        devices = [d for _, d in self.replicas]
        cpu = torch.device("cpu")
        shards, pad = shard_batch(devices, *(
            _to_device(a, cpu) for a in (image_nhwc, sketch_nhw1)))
        outs = [None] * len(devices)
        errors = []

        def run(i):
            model, device = self.replicas[i]
            try:
                with _on(device), torch.inference_mode():
                    outs[i] = [t.cpu() for t in _edit(model, *shards[i])]
            except BaseException as e:     # re-raised in the caller
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(1, len(devices))]
        for t in threads:
            t.start()
        run(0)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return tuple(gather([o[j] for o in outs], cpu, pad).numpy()
                     for j in range(2))


def build_pipeline(opt, *, require_checkpoint: bool = False,
                   seed: int = 0) -> EditPipeline:
    """Model on ``opt.device`` (cuda by default) from the checkpoints under
    ``opt.checkpoints_dir/opt.name``; a missing net gets a fresh init from
    ``seed`` with a WARNING, or raises under ``require_checkpoint``. More
    than one device (``devices_from_opt``) gives a replica on each, unless
    the attention is sharded over them."""
    config = config_from_opt(opt)
    set_precision(config.precision)
    devices = devices_from_opt(opt)
    if config.netg.attention_impl == "sharded":
        # the shards own the devices; the batch runs whole on the first
        devices = devices[:1]
    device = devices[0]

    model = EditLine2(config, device=device)
    states, missing = ckpt.load_pipeline(opt)
    for label, state in states.items():
        getattr(model, f"net{label}").load_state_dict(state, strict=True)
    if missing:
        msg = (f"checkpoints missing for nets {missing} under "
               f"{opt.checkpoints_dir}/{opt.name} (epoch "
               f"{getattr(opt, 'which_epoch', 'latest')})")
        if require_checkpoint:
            raise FileNotFoundError(msg)
        print(f"WARNING: {msg}; using fresh init for those nets")
        editline2.init_nets_(model, missing, seed,
                             init_type=getattr(opt, "init_type", "xavier"),
                             gain=getattr(opt, "init_variance", 0.02))
    model.eval()
    replicas = []
    if len(devices) > 1:
        replicas = [(model, device)] + list(zip(
            replicate(model, devices[1:]), devices[1:]))
    return EditPipeline(model=model, config=config, device=device,
                        replicas=replicas)
