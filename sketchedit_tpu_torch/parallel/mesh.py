"""Device lists for data parallelism (counterpart of
``sketchedit_tpu/parallel/mesh.py``).

The JAX package puts the batch axis on a one-axis device mesh and lets XLA
place the shards. Here a "mesh" is a plain list of ``torch.device``s: a
batch is split along its first axis into one shard per device, each shard
runs on its own copy of the module, and the outputs are gathered onto one
device. A list may name a device more than once: two shards then run on
the same device, which is how the CPU tests and a one-card machine drive
the multi-device code paths.
"""

from __future__ import annotations

import copy

import torch


def data_parallel_devices(n: int | None = None, devices=None):
    """The first ``n`` of ``devices`` (default: every visible CUDA device)
    as ``torch.device``s; all of them when ``n`` is None or 0. Raises when
    more are asked for than the list holds."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n or len(devices)
    if n > len(devices):
        raise ValueError(f"requested {n} devices, have {len(devices)}: "
                         f"{[str(d) for d in devices]}")
    return devices[:n]


def shard_batch(devices, *tensors):
    """Split each tensor's first axis into ``len(devices)`` equal shards,
    one on each device. A batch that does not divide is padded first by
    repeating its last sample, as the JAX runner pads (its pad is sliced
    off after the gather). Returns ([shards of each tensor, per device],
    pad)."""
    n = len(devices)
    batch = tensors[0].shape[0]
    pad = (-batch) % n
    shards = []
    for t in tensors:
        if t.shape[0] != batch:
            raise ValueError(f"batch sizes differ: {t.shape[0]} != {batch}")
        if pad:
            t = torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])
        shards.append([s.to(d, non_blocking=True)
                       for s, d in zip(t.chunk(n), devices)])
    return [list(per_device) for per_device in zip(*shards)], pad


def gather(shards, device, pad: int = 0):
    """Concatenate per-device shards along the first axis on ``device`` and
    drop the last ``pad`` rows."""
    out = torch.cat([s.to(device) for s in shards])
    return out[:out.shape[0] - pad] if pad else out


def replicate(module: torch.nn.Module, devices):
    """One copy of ``module`` per device, in the order of ``devices`` (a
    device named twice gets two copies)."""
    return [copy.deepcopy(module).to(d) for d in devices]
