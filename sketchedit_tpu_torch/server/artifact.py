"""Self-contained serving artifacts through ``torch.export`` (counterpart of
``sketchedit_tpu/server/artifact.py``).

A deployment host should need neither the model code nor a checkpoint nor
the converter: only a program and its uint8-in, uint8-out contract.
``export_edit_artifact`` traces ``models/editline2.py::edit_u8`` with the
weights baked in (uint8 image and sketch in, uint8 composite and mask out,
the single invocation that serving runs) and saves it with
``torch.export.save`` as a ``.pt2`` file; ``load_edit_artifact`` loads it
and returns a callable. The contextual attention is a custom op of
``ops/attention_cuda.py`` in the graph, so the program runs the same
hand-written kernel as the live model; the forward kernel that the
``SKETCHEDIT_*`` switches chose at export time is baked in, as the JAX
artifact bakes its Pallas call.

An artifact pins its device type, size, batch, dtype, attention route,
packed or plain fronts and tails (``pack``) and float32 precision: one
file per served configuration, as the executor's buckets. The metadata
travels inside the file (``extra_files``) and, for reading, in a ``.json``
sidecar. Loading imports the kernels' op module and no model module. TF32
is a process-wide PyTorch switch, outside the graph, so the loader applies
the artifact's precision itself.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from sketchedit_tpu_torch.device import set_precision
from sketchedit_tpu_torch.ops import attention_cuda   # registers the ops

META_FILE = "sketchedit_meta.json"


def export_edit_artifact(model, out_path: str, *, size: int = 256,
                         batch: int = 1, config=None) -> dict:
    """Save ``edit_u8(model, ...)`` at a fixed (batch, size) on the model's
    device to ``out_path`` (+ a ``.json`` sidecar); returns the metadata.
    ``config`` is the model's ``EditLine2Config`` (its own by default).
    The nets' route (``pack``) is ``use_packing`` of ``batch`` and the
    dtype under the model's float32 precision (which loading applies),
    fixed in the program."""
    from sketchedit_tpu_torch.models import editline2
    from sketchedit_tpu_torch.ops.packed_tail import (
        frozen_packed_params, use_packing)

    config = model.config if config is None else config
    if config != model.config:
        raise ValueError("config must be the model's own configuration")
    device = next(model.parameters()).device
    route = config.netg.attention_route(device)
    if route == "sharded":
        raise ValueError("an artifact runs on one device: export a model "
                         "with attention_impl 'kernel', 'dense' or 'auto'")
    class EditU8(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, image_u8, sketch_u8):
            return editline2.edit_u8(self.model, image_u8, sketch_u8)

    args = (torch.zeros((batch, size, size, 3), dtype=torch.uint8,
                        device=device),
            torch.zeros((batch, size, size, 1), dtype=torch.uint8,
                        device=device))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    set_precision(config.precision)
    try:
        pack = use_packing(batch, config.dtype)     # an eval-mode net's
        with torch.no_grad():
            # one eager call keeps the packed kernels of the current
            # weights, which the program then holds as constants
            EditU8().eval()(*args)
            with frozen_packed_params():
                program = torch.export.export(EditU8().eval(), args)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    meta = {
        "size": size, "batch": batch, "platforms": [device.type],
        "compute_dtype": config.compute_dtype,
        "attention_impl": route,
        "forward_kernel": (attention_cuda.forward_kernel()
                           if route == "kernel" else None),
        "precision": config.precision or "default",
        "pack": pack,
        "input": "uint8 image (B,S,S,3) + uint8 sketch (B,S,S,1)",
        "output": "uint8 composite (B,S,S,3) + uint8 mask (B,S,S,1)",
    }
    torch.export.save(program, out_path,
                      extra_files={META_FILE: json.dumps(meta)})
    meta["bytes"] = os.path.getsize(out_path)
    with open(out_path + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def load_edit_artifact(path: str):
    """Load an artifact -> ``call(image_u8, sketch_u8)`` -> (composite_u8,
    mask_u8), tensors on the artifact's device; numpy or tensor inputs.
    ``call.meta`` holds the metadata: batch, size and device come from the
    program's own input specs, so a bare ``.pt2`` serves; the rest from
    the file and, where present, the sidecar. Applies the artifact's
    float32 precision (``device.set_precision``)."""
    extra = {META_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    user_inputs = set(program.graph_signature.user_inputs)
    image_spec = next(node.meta["val"] for node in program.graph.nodes
                      if node.op == "placeholder" and node.name in user_inputs)
    device = image_spec.device
    meta = {"batch": int(image_spec.shape[0]),
            "size": int(image_spec.shape[1]),
            "platforms": [device.type], "bytes": os.path.getsize(path)}
    if extra[META_FILE]:
        meta.update(json.loads(extra[META_FILE]))
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta.update(json.load(f))
    set_precision(None if meta.get("precision") == "default" else "highest")
    module = program.module()

    def call(image, sketch):
        image, sketch = (torch.as_tensor(x).to(device)
                         for x in (image, sketch))
        return module(image, sketch)

    call.meta = meta
    call.device = device
    return call


class ArtifactPipeline:
    """Executor-compatible pipeline backed by artifacts alone: the serving
    host needs the ``.pt2`` files, not the model code.

    Each artifact is pinned to one batch size; a request batch pads up to
    the smallest artifact batch that fits (repeating its last row).
    ``size`` and ``max_batch`` mirror the metadata so the serve CLI can
    clip its flags to them. The call runs with the artifact's device
    current and under inference mode (the executor calls it from its
    dispatcher thread) and returns numpy, as ``runner.EditPipeline``
    does."""

    def __init__(self, paths):
        calls = [load_edit_artifact(p) for p in paths]
        self.by_batch = {c.meta["batch"]: c for c in calls}
        for key in ("size", "precision", "platforms"):
            values = {json.dumps(c.meta.get(key)) for c in calls}
            if len(values) != 1:
                raise ValueError(f"artifacts disagree on {key}: {values}")
        self.size = calls[0].meta["size"]
        self.device = calls[0].device
        self.batches = sorted(self.by_batch)
        self.max_batch = self.batches[-1]

    def __call__(self, images, sketches):
        n = images.shape[0]
        b = next((s for s in self.batches if s >= n), None)
        if b is None:
            raise ValueError(f"batch {n} exceeds the largest artifact "
                             f"batch {self.max_batch}")
        if b > n:
            images = np.concatenate(
                [images, np.repeat(images[-1:], b - n, axis=0)])
            sketches = np.concatenate(
                [sketches, np.repeat(sketches[-1:], b - n, axis=0)])
        on = (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext())
        with on, torch.inference_mode():
            composed, mask = self.by_batch[b](
                np.ascontiguousarray(images), np.ascontiguousarray(sketches))
            return composed.cpu().numpy()[:n], mask.cpu().numpy()[:n]
