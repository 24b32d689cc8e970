"""One rank of a data-parallel train step on the CPU over gloo, for
tests/test_torch_parallel.py (a module of its own, so that a spawned rank
imports torch and the port and not JAX)."""

import numpy as np
import torch

GAIN_M, GAIN_G = 1.7, 1.5


def port_state(cfg, seed=0):
    """A fresh port train state on the CPU with netM and netG scaled so
    that their outputs are not flat (test_torch_train.py's weights)."""
    from sketchedit_tpu_torch.train import trainer as tr
    state = tr.init_train_state(cfg, seed=seed, device="cpu")
    with torch.no_grad():
        for label, gain in (("M", GAIN_M), ("G", GAIN_G)):
            for conv in state.nets[label].children():
                conv.weight.mul_(gain)
    return state


def rank_step(rank, world, init_method, batch_path, out_path):
    """Rank ``rank``: join the group, take rank 0's state, run one
    ``train_loop`` step on this rank's rows of the global batch (flags drawn
    from the state's generator), and save the state dicts, the metrics and
    the flags of the next three draws to ``out_path``."""
    import torch.distributed as dist

    from sketchedit_tpu_torch.cli.train import train_loop
    from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
    from sketchedit_tpu_torch.parallel import distributed
    from sketchedit_tpu_torch.train import trainer as tr

    torch.set_num_threads(1)
    distributed.init(rank, world, "gloo", init_method)
    try:
        cfg = tr.TrainConfig(netg=DeepFillConfig(attention_impl="kernel"))
        state = port_state(cfg, seed=rank)    # rank 0's after the broadcast
        distributed.broadcast_(distributed.train_state_tensors(state))
        with np.load(batch_path) as f:
            batch = {k: f[k] for k in f.files}
        rows = len(batch["image"]) // world
        mine = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
        seen = []
        train_loop(state, [mine], cfg, on_step=seen.append,
                   group=dist.group.WORLD)
        out = {f"{label}.{k}": v.numpy()
               for label, net in state.nets.items()
               for k, v in net.state_dict().items()}
        out.update({f"metric.{k}": np.float32(v) for k, v in seen[0].items()})
        out["next_flags"] = np.array(
            [tr.draw_flags(state, cfg) for _ in range(3)])
        np.savez(out_path, **out)
    finally:
        distributed.close()
