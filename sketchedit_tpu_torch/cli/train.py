"""Training CLI on the port (counterpart of ``sketchedit_tpu/cli/train.py``).

    python -m sketchedit_tpu_torch.cli.train --name run --dataset_mode editimage \\
        --train_image_dir /data/images --batchSize 8 --use_cam --pool_type max \\
        --joint_train_inp [--device cuda|cpu]

One G+D step per batch (``train/trainer.py``), checkpoints with the
reference's ``{epoch}_net_{M,G,D}`` naming in the JAX layout, the full
training state in ``train_state_latest.pt``, ``iter.txt`` resume, and a
checkpoint-and-exit at the next step after SIGTERM or SIGINT (exit code
128 + the signal). Held-out validation and multi-GPU runs are not ported
and raise. ``train_loop`` runs the steps over any iterable of batches.
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
from sketchedit_tpu_torch.utils.iter_counter import IterationCounter


def train_loop(state, batches, cfg: TrainConfig, *, vgg_params=None,
               on_step=None):
    """One ``train_step`` per batch of numpy arrays (a loader batch), on the
    device of the state's nets, with branch flags drawn from the state's
    generator. ``on_step(metrics)`` runs after each step."""
    device = next(state.nets["G"].parameters()).device
    for batch in batches:
        if not cfg.lambda_mask_rec:
            batch = {k: v for k, v in batch.items() if k != "region_gt"}
        flag_g, flag_d = draw_flags(state, cfg)
        _, metrics = train_step(state, batch_to_device(batch, device),
                                flag_g, flag_d, cfg, vgg_params)
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
    if opt.val_image_dir:
        raise NotImplementedError(
            "--val_image_dir: held-out validation is not ported yet "
            "(ROADMAP.md queue 1 item 11)")
    if opt.data_parallel > 1 or len(opt.gpu_ids) > 1:
        raise NotImplementedError(
            "multi-GPU training is not ported yet (ROADMAP.md queue 1 "
            "item 12); run on one GPU")


def main():
    opt = TrainOptions().parse()
    check_ported(opt)
    device = resolve_device(opt.device)

    dataloader = data.create_dataloader(opt)
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
            print(f"epoch {epoch} iter {iter_counter.epoch_iter} "
                  f"({iter_counter.time_per_iter * 1000:.0f} ms/img) {vals}",
                  flush=True)
        if iter_counter.needs_saving():
            save_latest()
            iter_counter.record_current_iter()

    signal.signal(signal.SIGTERM, request_stop)
    signal.signal(signal.SIGINT, request_stop)

    for epoch in iter_counter.training_epochs():
        iter_counter.record_epoch_start(epoch)
        train_loop(state, dataloader, cfg, vgg_params=vgg_params,
                   on_step=on_step)
        iter_counter.record_epoch_end()
        if (epoch % opt.save_epoch_freq == 0
                or epoch == iter_counter.total_epochs):
            ckpt.save_pipeline(state.nets, epoch, opt)   # and 'latest'
            ckpt.save_train_state(state, opt)
            print(f"saved the model at the end of epoch {epoch}")


if __name__ == "__main__":
    main()
