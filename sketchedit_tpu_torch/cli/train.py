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
(``data/__init__.py``). Multi-GPU runs are not ported and raise.
``train_loop`` runs the steps over any iterable of batches.
"""

from __future__ import annotations

import signal

from sketchedit_tpu_torch import data
from sketchedit_tpu_torch.device import resolve_device
from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
from sketchedit_tpu_torch.options.train_options import TrainOptions
from sketchedit_tpu_torch.params import checkpoint as ckpt
from sketchedit_tpu_torch.runner import set_precision
from sketchedit_tpu_torch.train.losses import load_vgg_params
from sketchedit_tpu_torch.train.trainer import (
    TrainConfig, batch_to_device, draw_flags, init_train_state, train_step)
from sketchedit_tpu_torch.train.validation import (
    MetricsLog, build_validator, is_improvement, recover_best,
    resolve_val_track)
from sketchedit_tpu_torch.utils.iter_counter import IterationCounter


def train_loop(state, batches, cfg: TrainConfig, *, vgg_params=None,
               on_step=None):
    """One ``train_step`` per batch of numpy arrays (a loader batch), on the
    device of the state's nets, with branch flags drawn from the state's
    generator. ``on_step(metrics)`` runs after each step.

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
                                vgg_params)
        if on_step is not None:
            on_step(metrics)


def config_from_opt(opt, steps_per_epoch: int, vgg_found: bool) -> TrainConfig:
    return TrainConfig(
        netg=DeepFillConfig(
            use_cam=opt.use_cam, pool_type=opt.pool_type,
            no_mask_cc=opt.no_mask_cc, no_mask_coarse=opt.no_mask_coarse,
            joint_train_inp=opt.joint_train_inp,
            attention_impl=opt.attention_impl),
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


def check_ported(opt):
    """Raise on the options whose code paths the port does not have."""
    if opt.data_parallel > 1 or len(opt.gpu_ids) > 1:
        raise NotImplementedError(
            "multi-GPU training is not ported yet (ROADMAP.md queue 1 "
            "item 12); run on one GPU")


def main():
    opt = TrainOptions().parse()
    check_ported(opt)
    device = resolve_device(opt.device)

    dataloader = data.create_dataloader(opt)
    print(f"loader: {dataloader.mode}, nThreads {dataloader.num_workers}")
    steps_per_epoch = max(1, len(dataloader.dataset) // opt.batchSize)
    vgg_params = load_vgg_params(device=device)
    cfg = config_from_opt(opt, steps_per_epoch, vgg_params is not None)
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

    opt.val_track = resolve_val_track(opt)
    metrics_log = MetricsLog.from_opt(opt)
    validator = build_validator(opt, cfg)
    best_val = None
    if opt.continue_train and metrics_log is not None:
        best_val = recover_best(metrics_log.path, opt.val_track)
        if best_val is not None:
            print(f"resumed best {opt.val_track} = {best_val}")
    if validator is not None:
        print(f"validation: {validator.image.shape[0]} held-out items "
              f"from {opt.val_image_dir} every {opt.val_epoch_freq} epochs "
              f"(best checkpoint tracks {opt.val_track})")

    iter_counter = IterationCounter(opt, len(dataloader.dataset))
    stop_signum = None

    def request_stop(signum, _frame):
        nonlocal stop_signum
        if stop_signum is not None:       # second signal: exit now
            raise SystemExit(128 + signum)
        stop_signum = signum
        print(f"signal {signum}: will checkpoint and exit after this step")

    def save_latest():
        ckpt.save_pipeline(state.nets, "latest", opt)
        ckpt.save_train_state(state, opt)

    def on_step(metrics):
        iter_counter.record_one_iteration()
        if stop_signum is not None:
            save_latest()
            iter_counter.record_current_iter()
            print(f"checkpointed on signal {stop_signum}; exiting",
                  flush=True)
            raise SystemExit(128 + stop_signum)
        if iter_counter.needs_printing():
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
                       on_step=on_step)
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
            if (epoch % opt.save_epoch_freq == 0
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
