"""Training CLI on the port (counterpart of ``sketchedit_tpu/cli/train.py``).

    python -m sketchedit_tpu_torch.cli.train --name run --dataset_mode editimage \\
        --train_image_dir /data/images --batchSize 8 --use_cam --pool_type max \\
        --joint_train_inp [--device cuda|cpu]

One G+D step per batch (``train/trainer.py``), checkpoints with the
reference's ``{epoch}_net_{M,G,D}`` naming in the JAX layout, the full
training state in ``train_state_latest.pt``, ``iter.txt`` resume, and a
checkpoint-and-exit at the next step after SIGTERM or SIGINT (exit code
128 + the signal). With ``--val_image_dir``, a held-out batch is scored
every ``--val_epoch_freq`` epochs and at the last one (``train/
validation.py``), and each improvement of ``--val_track`` saves
``best_net_{M,G,D}``. ``--metrics_log`` (default ``auto``: ``metrics.jsonl``
in the run directory) gets a ``train`` row at every print and a ``val`` row
per validation. ``--nThreads`` selects the loader's workers
(``data/__init__.py``). ``train_loop`` runs the steps over any iterable of
batches.

Data-parallel training (the JAX CLI's, which runs whenever it sees more
than one device): ``--data_parallel N`` > 1, or 0 with more than one
visible card, runs N ranks, rank r on the r-th device of ``--gpu_ids``
(``runner.devices_from_opt``; ``--gpu_ids 0,0`` puts two ranks on one card;
``--device cpu`` puts N ranks on the CPU). Started by ``torchrun`` the CLI
takes the launcher's ranks; otherwise it spawns ranks 1..N-1 and is rank 0
itself. ``--batchSize`` is the global batch: each rank reads its rows of
it, and the gradients are averaged over the ranks at every step
(``parallel/distributed.py``). An explicit N that does not divide the
batch raises; with 0 the run falls back to one card. Rank 0 alone prints,
writes the checkpoints, ``iter.txt`` and the metrics log, and validates.
The ranks agree on a stop signal after each step, so all of them stop
after the same step and rank 0 writes the checkpoint once.
``--attention_impl sharded`` splits the attention's query patches over the
devices instead, in one process.
"""

from __future__ import annotations

import multiprocessing
import os
import signal
import sys

import torch

from sketchedit_tpu_torch import data
from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
from sketchedit_tpu_torch.options.train_options import TrainOptions
from sketchedit_tpu_torch.parallel import distributed
from sketchedit_tpu_torch.params import checkpoint as ckpt
from sketchedit_tpu_torch.runner import devices_from_opt, set_precision
from sketchedit_tpu_torch.train.losses import load_vgg_params
from sketchedit_tpu_torch.train.trainer import (
    TrainConfig, batch_to_device, draw_flags, init_train_state, train_step)
from sketchedit_tpu_torch.train.validation import (
    MetricsLog, build_validator, is_improvement, recover_best,
    resolve_val_track)
from sketchedit_tpu_torch.utils.iter_counter import IterationCounter


def train_loop(state, batches, cfg: TrainConfig, *, vgg_params=None,
               on_step=None, group=None):
    """One ``train_step`` per batch of numpy arrays (a loader batch), on the
    device of the state's nets, with branch flags drawn from the state's
    generator; with a process ``group``, averaged over its ranks.
    ``on_step(metrics)`` runs after each step.

    Each batch is staged (pinned, then copied asynchronously) before the
    step of the batch ahead of it is dispatched, so reading and pinning it
    overlaps the step on the device. PyTorch's caching host allocator keeps
    a pinned block from reuse until the copy that reads it has passed."""
    device = next(state.nets["G"].parameters()).device

    def stage(batch):
        if batch is None:
            return None
        if not cfg.lambda_mask_rec:
            batch = {k: v for k, v in batch.items() if k != "region_gt"}
        return batch_to_device(batch, device)

    batch_it = iter(batches)
    staged = stage(next(batch_it, None))
    while staged is not None:
        current = staged
        staged = stage(next(batch_it, None))
        flag_g, flag_d = draw_flags(state, cfg)
        _, metrics = train_step(state, current, flag_g, flag_d, cfg,
                                vgg_params, group=group)
        if on_step is not None:
            on_step(metrics)


def config_from_opt(opt, steps_per_epoch: int, vgg_found: bool,
                    shard_devices=()) -> TrainConfig:
    """The step's configuration; ``--attention_impl sharded`` needs more
    than one of ``shard_devices`` and otherwise falls back to 'auto' with a
    warning, as the JAX CLI does."""
    impl = opt.attention_impl
    if impl == "sharded" and len(shard_devices) < 2:
        print("WARNING: --attention_impl sharded needs >1 device; "
              "falling back to 'auto'")
        impl = "auto"
    return TrainConfig(
        netg=DeepFillConfig(
            use_cam=opt.use_cam, pool_type=opt.pool_type,
            no_mask_cc=opt.no_mask_cc, no_mask_coarse=opt.no_mask_coarse,
            joint_train_inp=opt.joint_train_inp,
            attention_impl=impl,
            attention_devices=(tuple(shard_devices) if impl == "sharded"
                               else ())),
        gan_mode=opt.gan_mode, lambda_l1=opt.lambda_l1,
        lambda_l1_mask=opt.lambda_l1_mask, lambda_vgg=opt.lambda_vgg,
        lambda_mask_rec=opt.lambda_mask_rec, no_gan_loss=opt.no_gan_loss,
        no_vgg_loss=opt.no_vgg_loss or not vgg_found,
        vgg_imagenet_norm=bool(opt.vgg_imagenet_norm),
        precision=None if opt.precision == "default" else opt.precision,
        init_type=opt.init_type, init_gain=opt.init_variance,
        filt_maskim=opt.filt_maskim, no_detach=opt.no_detach,
        netd=opt.netD, num_d=opt.num_D, update_part=opt.update_part,
        lr=opt.lr, beta1=opt.beta1, beta2=opt.beta2, no_TTUR=opt.no_TTUR,
        remat=opt.remat, reuse_fake=opt.reuse_fake,
        lr_decay_start=opt.niter * steps_per_epoch,
        lr_decay_steps=opt.niter_decay * steps_per_epoch,
        compute_dtype=opt.compute_dtype)


def rank_devices(opt, world: int | None = None):
    """(ranks, devices) of a run: rank r trains on ``devices[r]``;
    ``--attention_impl sharded`` is one rank whose shards take every
    device. ``world`` is torchrun's world size, when it started the run."""
    devices = devices_from_opt(opt)
    if opt.attention_impl == "sharded" and world is None:
        return 1, devices
    n = world or len(devices)
    if n > 1 and opt.batchSize % n:
        if world or opt.data_parallel:
            raise ValueError(f"--batchSize {opt.batchSize} does not divide "
                             f"over {n} data-parallel ranks")
        print(f"NOTE: batchSize {opt.batchSize} not divisible by {n} "
              "devices; running single-device")
        return 1, devices[:1]
    return n, devices


def _spawned_rank(argv, rank: int, world: int, init_method: str):
    """Rank ``rank`` > 0 of a run that rank 0 spawned: the same options,
    its own device, no output on stdout."""
    sys.stdout = open(os.devnull, "w")
    sys.argv = argv
    opt = TrainOptions().parse(save=False)
    _, devices = rank_devices(opt)
    run(opt, rank, world, devices[rank], distributed.backend_for(devices),
        init_method)


def main():
    launched = distributed.launched_by_torchrun()
    if launched is not None and launched[0] > 0:
        sys.stdout = open(os.devnull, "w")        # rank 0 alone prints
    opt = TrainOptions().parse(
        save=None if launched is None or launched[0] == 0 else False)
    if launched is not None:
        rank, world, local_rank = launched
        _, devices = rank_devices(opt, world)
        # this node's ranks: local rank l on the l-th card of the list, or
        # every one on the CPU
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if devices[0].type == "cpu":
            devices = devices[:1] * n_local
        run(opt, rank, world, devices[local_rank],
            distributed.backend_for(devices[:n_local]))
        return
    world, devices = rank_devices(opt)
    if world == 1:
        run(opt, 0, 1, devices[0], shard_devices=devices)
        return
    print(f"data-parallel over {world} ranks: "
          f"{', '.join(map(str, devices))}")
    init_method = distributed.free_tcp_address()
    ctx = multiprocessing.get_context("spawn")
    children = [ctx.Process(target=_spawned_rank,
                            args=(sys.argv, r, world, init_method))
                for r in range(1, world)]
    for c in children:
        c.start()
    stopped = (0, 128 + signal.SIGTERM, 128 + signal.SIGINT)
    ok = False
    try:
        run(opt, 0, world, devices[0], distributed.backend_for(devices),
            init_method)
        ok = True
    except SystemExit as e:       # a stop signal: the ranks stop together
        ok = e.code in stopped
        raise
    finally:
        # the other ranks end with rank 0 (the step after a stop signal, or
        # the last one); rank 0 alone saves and validates after it
        for c in children:
            c.join(120 if ok else 10)
            if c.is_alive():
                c.kill()
                c.join()
        if ok and any(c.exitcode not in stopped for c in children):
            raise RuntimeError(f"a data-parallel rank failed: exit codes "
                               f"{[c.exitcode for c in children]}")


def run(opt, rank: int, world: int, device, backend: str | None = None,
        init_method: str | None = None, shard_devices=()):
    """Train as rank ``rank`` of ``world`` on ``device``; with ``world`` >
    1, join the process group first (``backend``; ``init_method`` None
    reads torchrun's environment). ``shard_devices``: the devices of a
    sharded attention (one rank)."""
    group = host = None
    if world > 1:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        host = distributed.init(rank, world, backend, init_method)
        group = torch.distributed.group.WORLD
    try:
        _train(opt, rank, world, device, shard_devices, group, host)
    finally:
        distributed.close()


def _train(opt, rank, world, device, shard_devices, group, host):
    lead = rank == 0
    dataloader = data.create_dataloader(opt, rank=rank, world=world)
    print(f"loader: {dataloader.mode}, nThreads {dataloader.num_workers}")
    steps_per_epoch = max(1, len(dataloader.dataset) // opt.batchSize)
    vgg_params = load_vgg_params(device=device)
    cfg = config_from_opt(opt, steps_per_epoch, vgg_params is not None,
                          shard_devices)
    if cfg.no_vgg_loss:
        vgg_params = None
    set_precision(cfg.precision)

    state = init_train_state(cfg, seed=0, flag_seed=opt.niter, device=device)
    if opt.continue_train and ckpt.load_train_state(opt, state):
        print(f"resumed full train state at step {state.step}")
    for label, path in (("M", opt.load_pretrained_mask),
                        ("G", opt.load_pretrained_g),
                        ("D", opt.load_pretrained_d)):
        if path:
            state.nets[label].load_state_dict(ckpt.load_network_path(path))
            print(f"loaded pretrained net {label} from {path}")
        elif opt.continue_train and state.step == 0:
            loaded = ckpt.load_network(label, opt)
            if loaded is not None:
                state.nets[label].load_state_dict(loaded)
                print(f"resumed net {label} (weights only)")

    if group is not None:
        # rank 0's state everywhere (the ranks built and resumed the same
        # one; this makes sure)
        distributed.broadcast_(distributed.train_state_tensors(state),
                               group=group)

    opt.val_track = resolve_val_track(opt)
    metrics_log = MetricsLog.from_opt(opt) if lead else None
    validator = build_validator(opt, cfg) if lead else None
    best_val = None
    if opt.continue_train and metrics_log is not None:
        best_val = recover_best(metrics_log.path, opt.val_track)
        if best_val is not None:
            print(f"resumed best {opt.val_track} = {best_val}")
    if validator is not None:
        print(f"validation: {validator.image.shape[0]} held-out items "
              f"from {opt.val_image_dir} every {opt.val_epoch_freq} epochs "
              f"(best checkpoint tracks {opt.val_track})")

    iter_counter = IterationCounter(opt, len(dataloader.dataset),
                                    record=lead)
    stop_signum = None

    def request_stop(signum, _frame):
        nonlocal stop_signum
        if stop_signum is not None:       # second signal: exit now
            raise SystemExit(128 + signum)
        stop_signum = signum
        print(f"signal {signum}: will checkpoint and exit after this step")

    def save_latest():
        if lead:
            ckpt.save_pipeline(state.nets, "latest", opt)
            ckpt.save_train_state(state, opt)

    def on_step(metrics):
        iter_counter.record_one_iteration()
        stop = stop_signum or 0
        if host is not None:      # every rank stops after the same step
            stop = distributed.agree_max(stop, host)
        if stop:
            save_latest()
            iter_counter.record_current_iter()
            print(f"checkpointed on signal {stop}; exiting", flush=True)
            raise SystemExit(128 + stop)
        if lead and iter_counter.needs_printing():
            vals = {k: round(float(v), 4) for k, v in metrics.items()}
            ms_per_img = iter_counter.time_per_iter * 1000
            print(f"epoch {epoch} iter {iter_counter.epoch_iter} "
                  f"({ms_per_img:.0f} ms/img) {vals}", flush=True)
            if metrics_log is not None:
                metrics_log.log({"kind": "train", "epoch": epoch,
                                 "iter": iter_counter.epoch_iter,
                                 "ms_per_img": round(ms_per_img, 1),
                                 "losses": vals})
        if iter_counter.needs_saving():
            save_latest()
            iter_counter.record_current_iter()

    signal.signal(signal.SIGTERM, request_stop)
    signal.signal(signal.SIGINT, request_stop)

    try:
        for epoch in iter_counter.training_epochs():
            iter_counter.record_epoch_start(epoch)
            train_loop(state, dataloader, cfg, vgg_params=vgg_params,
                       on_step=on_step, group=group)
            iter_counter.record_epoch_end()
            if validator is not None and (
                    epoch % opt.val_epoch_freq == 0
                    or epoch == iter_counter.total_epochs):
                vals = {k: round(v, 4)
                        for k, v in validator.run(state.nets).items()}
                if is_improvement(opt.val_track, vals[opt.val_track],
                                  best_val):
                    best_val = vals[opt.val_track]
                    ckpt.save_pipeline(state.nets, "best", opt)
                    vals["best"] = True
                print(f"validation epoch {epoch}: {vals}", flush=True)
                if metrics_log is not None:
                    metrics_log.log({"kind": "val", "epoch": epoch, **vals})
            if lead and (epoch % opt.save_epoch_freq == 0
                         or epoch == iter_counter.total_epochs):
                ckpt.save_pipeline(state.nets, epoch, opt)   # and 'latest'
                ckpt.save_train_state(state, opt)
                print(f"saved the model at the end of epoch {epoch}")
    finally:
        dataloader.close()
        if metrics_log is not None:
            metrics_log.close()


if __name__ == "__main__":
    main()
