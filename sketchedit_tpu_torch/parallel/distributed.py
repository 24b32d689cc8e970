"""Data-parallel training across processes: one rank per device, each on
its own rows of every global batch.

The JAX trainer gets its gradient reduction from XLA, which inserts a psum
when the batch axis of the jitted step is sharded. Here the ranks do it by
hand: every loss of the step is a ``.mean()`` over the batch, so the mean
of the ranks' gradients on equal shards is the gradient of the global
batch, and ``all_reduce_mean_`` averages them in one flat bucket between
the gradient and the optimizer step (``train/trainer.py``). The nets are
not wrapped in ``DistributedDataParallel``: the steps take their gradients
with ``torch.autograd.grad``, where DDP's hooks never fire. The train
state starts equal on every rank (``broadcast_``), and the branch flags and
the spectral norm's power iteration depend only on state that the ranks
keep equal (the flag generator's seed, the weights).

On the card only ``broadcast`` and ``all_reduce`` are used, the two
collectives that gloo supports on CUDA tensors. NCCL runs when every rank
has a card of its own; gloo when two ranks share a card (NCCL refuses
that) or on the CPU. Host-side agreement (the stop signal) goes through a
gloo group on CPU tensors, so it never waits for the device.
"""

from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist


def launched_by_torchrun():
    """(rank, world size, local rank) from ``torchrun``'s environment, or
    None when the process was not started by it (or as a world of one)."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or "RANK" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def free_tcp_address() -> str:
    """``tcp://localhost:<port>`` on a port that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"tcp://localhost:{s.getsockname()[1]}"


def backend_for(devices) -> str:
    """'nccl' when every rank has a CUDA device of its own, else 'gloo'."""
    devices = [torch.device(d) for d in devices]
    if (all(d.type == "cuda" for d in devices)
            and len(set(devices)) == len(devices)):
        return "nccl"
    return "gloo"


def init(rank: int, world: int, backend: str, init_method: str | None = None):
    """Join the default process group; returns the group for host-side
    agreement (the default one under gloo, a gloo group beside NCCL).
    ``init_method`` None reads torchrun's environment (``env://``)."""
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank)
    if backend == "nccl":
        return dist.new_group(backend="gloo")
    return dist.group.WORLD


def close():
    if dist.is_initialized():
        dist.destroy_process_group()


def broadcast_(tensors, src: int = 0, group=None):
    """Every rank's ``tensors`` become rank ``src``'s, in place. A
    collective's write does not move a tensor's version counter, so each
    is moved here: what is kept from a tensor's old values (the packed
    kernels of ``ops/packed_tail.py``) is then formed again."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src, group=group)
            torch.autograd.graph.increment_version(t)


def train_state_tensors(state):
    """The tensors that make a train state: every net's parameters and
    buffers (the spectral norm's ``u``), then the optimizers' moments (a
    resumed state has them), in an order that is the same on every rank.
    Adam's step count, a CPU tensor, is left out: it is ``state.step`` on
    every rank."""
    out = [t for label in sorted(state.nets)
           for t in (*state.nets[label].parameters(),
                     *state.nets[label].buffers())]
    for opt in (state.opt_g, state.opt_d):
        for group in opt.param_groups:
            for p in group["params"]:
                out += [v for _, v in sorted(opt.state.get(p, {}).items())
                        if torch.is_tensor(v) and v.device == p.device]
    return out


def all_reduce_mean_(tensors, group=None):
    """Average same-dtype ``tensors`` over the group's ranks in place,
    through one flat bucket (one collective)."""
    tensors = list(tensors)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def agree_max(value: int, group) -> int:
    """The largest ``value`` over the group's ranks (a host-side value, on
    a gloo group)."""
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())
