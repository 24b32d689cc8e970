"""One G+D training step of the EditLine2 pipeline (counterpart of
``sketchedit_tpu/train/trainer.py``).

* ``generate_fake_train``: the 3-way branch of the reference's generate_fake
  (0: inpainting with a random mask and the full edge map; 1: netM's soft
  mask, detached unless ``no_detach``; 2: netM's thresholded mask);
* ``g_image_loss``: the generator loss stack (GAN, VGG, L1 on both stages,
  the mask-image L1 terms, the optional mask BCE);
* ``_discriminate``: fake composited over real with the detached mask, fake
  and real in one concatenated batch, predictions split back;
* TTUR Adam at lr/2 (G) and lr*2 (D), betas (0, 0.9), with a constant then
  linearly decaying learning rate;
* ``update_part``: layers outside the selected groups get a zero gradient,
  as the JAX package's gradient masks give them.

The state is updated in place (parameters, optimizer moments and the ``u``
buffers of the discriminator), where the JAX step returns a new state.
Parameters stay float32 under ``compute_dtype`` bfloat16 (master weights):
the convs cast them per op. The G step takes its gradients with
``torch.autograd.grad`` over the generator's parameters, so it leaves none
on the discriminator; its call to D does not move ``u``. The caller draws
the G and D branch flags (``draw_flags``); the D step regenerates its fakes
with the updated generator and its own flag, unless ``reuse_fake``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.utils.checkpoint

from sketchedit_tpu_torch.models import deepfill_c2, discriminator, md_generator
from sketchedit_tpu_torch.models.deepfill_c2 import (
    DeepFillC2Generator, DeepFillConfig)
from sketchedit_tpu_torch.models.editline2 import DTYPES
from sketchedit_tpu_torch.models.md_generator import MDGenerator
from sketchedit_tpu_torch.ops.gated_conv import init_conv_
from sketchedit_tpu_torch.ops.image import gaussian_blur3x3
from sketchedit_tpu_torch.train import losses

_MASK_KEYS = ("mask", "edgegt", "random_mask", "random_mask2", "region_gt")


@dataclass(frozen=True)
class TrainConfig:
    netg: DeepFillConfig = field(default_factory=DeepFillConfig)
    gan_mode: str = "hinge"
    lambda_l1: float = 1.0
    lambda_l1_mask: float = 1.0
    lambda_mask_rec: float = 0.0    # direct netM supervision (off by default)
    lambda_vgg: float = 10.0
    no_gan_loss: bool = False
    no_vgg_loss: bool = True          # enable when VGG weights are provided
    vgg_imagenet_norm: bool = True
    filt_maskim: bool = False
    no_detach: bool = False
    update_part: str = "all"
    netd: str = "sngan"              # 'sngan' | 'multiscale'
    num_d: int = 2                   # scales for netd='multiscale'
    lr: float = 2e-4
    beta1: float = 0.0
    beta2: float = 0.9
    no_TTUR: bool = False
    mask_threshold: float = 0.5
    # None allows TF32 in convs and matmuls; 'highest' turns it off. The
    # trainer reads it only through the caller (runner.set_precision).
    precision: str | None = None
    compute_dtype: str = "float32"
    init_type: str = "kaiming"
    init_gain: float = 0.02
    remat: bool = False              # recompute the generator in backward
    reuse_fake: bool = False         # D trains on the G step's fakes
    # full lr for lr_decay_start steps, then linear to 0 over lr_decay_steps
    lr_decay_start: int = 0
    lr_decay_steps: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]

    @property
    def train_mask_only(self) -> bool:
        """True when update_part selects no generator layer."""
        return not deepfill_c2.param_groups(
            [n for n, *_ in deepfill_c2.LAYER_SPECS], self.update_part)

    @property
    def train_maskim(self) -> bool:
        return self.update_part == "maskim"

    def g_lr(self):
        return self.lr if self.no_TTUR else self.lr / 2

    def d_lr(self):
        return self.lr if self.no_TTUR else self.lr * 2

    def lr_at(self, base_lr: float, step: int) -> float:
        """The learning rate of update number ``step`` (0-based): optax's
        join of a constant and a linear schedule, as the JAX package
        builds it."""
        if self.lr_decay_steps <= 0 or step < self.lr_decay_start:
            return base_lr
        done = min(step - self.lr_decay_start, self.lr_decay_steps)
        return base_lr * (1.0 - done / self.lr_decay_steps)


@dataclass
class TrainState:
    nets: dict              # 'M', 'G', 'D' -> nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    flag_rng: torch.Generator   # draws the branch flags (draw_flags)
    step: int = 0


def make_optimizers(cfg: TrainConfig, nets):
    """The TTUR Adam pair (optax.adam's eps 1e-8); the learning rate is set
    per step from ``cfg.lr_at``."""
    betas = (cfg.beta1, cfg.beta2)
    gen = [*nets["M"].parameters(), *nets["G"].parameters()]
    opt_g = torch.optim.Adam(gen, lr=cfg.g_lr(), betas=betas, eps=1e-8)
    opt_d = torch.optim.Adam(nets["D"].parameters(), lr=cfg.d_lr(),
                             betas=betas, eps=1e-8)
    return opt_g, opt_d


def _grad_mask(cfg: TrainConfig, nets):
    """The generator parameters ``update_part`` trains, as a set of ids."""
    out = set()
    for label, groups in (("M", md_generator.param_groups),
                          ("G", deepfill_c2.param_groups)):
        net = nets[label]
        names = [n for n, _ in net.named_children()]
        for name in groups(names, cfg.update_part):
            out.update(id(p) for p in net.get_submodule(name).parameters())
    return out


def init_train_state(cfg: TrainConfig, *, seed: int = 0, flag_seed: int = 0,
                     device="cpu") -> TrainState:
    """Fresh nets on ``device`` (float32 parameters), each drawn on the CPU
    from its own generator seeded by ``seed``, so a seed gives the same
    weights on every device; M and G by ``cfg.init_type``, D xavier (gain
    0.02) with u ~ N(0, 1)."""
    d_net = (discriminator.MultiscaleDiscriminator(cfg.num_d, device=device)
             if cfg.netd == "multiscale"
             else discriminator.Discriminator(device=device))
    nets = {"M": MDGenerator(device=device),
            "G": DeepFillC2Generator(cfg.netg, device=device), "D": d_net}
    for i, label in enumerate(("M", "G")):
        gen = torch.Generator().manual_seed(3 * seed + i)
        for conv in nets[label].children():
            init_conv_(conv, gen, init_type=cfg.init_type, gain=cfg.init_gain)
    discriminator.init_(d_net, torch.Generator().manual_seed(3 * seed + 2))
    opt_g, opt_d = make_optimizers(cfg, nets)
    return TrainState(nets=nets, opt_g=opt_g, opt_d=opt_d,
                      flag_rng=torch.Generator().manual_seed(flag_seed))


def draw_flags(state: TrainState, cfg: TrainConfig):
    """Independent G and D branch flags for one step, in [0, 3), or [1, 3)
    without joint_train_inp (the reference draws one per generate_fake)."""
    low = 0 if cfg.netg.joint_train_inp else 1
    g, d = torch.randint(low, 3, (2,), generator=state.flag_rng).tolist()
    return g, d


def generate_fake_train(net_m, net_g, batch, flag: int, cfg: TrainConfig):
    """Train-mode generate_fake on an NCHW float32 batch; every output is
    float32 (the losses' dtype), the nets run in ``cfg.compute_dtype``."""
    cdt = cfg.dtype
    inputs = batch["image"].to(cdt)
    real = batch["gt"].to(cdt)
    line = batch["mask"].to(cdt)
    # the mask sigmoid runs in float32 (mask_bce_loss needs unsaturated
    # probabilities); netG reads the compute-dtype copy
    soft_mask, mask_image = net_m(inputs, line, mask_dtype=torch.float32)
    if flag == 0:
        m = batch["random_mask"].to(cdt)
        line_inpaint, inputs0 = batch["edgegt"].to(cdt) * m, real
    elif flag == 1:
        m = soft_mask.to(cdt)
        m = m if cfg.no_detach else m.detach()
        line_inpaint, inputs0 = line, inputs
    elif flag == 2:
        m = (soft_mask > cfg.mask_threshold).to(cdt).detach()
        line_inpaint, inputs0 = line, inputs
    else:
        raise ValueError(f"flag must be 0, 1 or 2, got {flag}")
    rm2 = (1.0 - batch["random_mask2"].to(cdt)) * m
    coarse, fake = net_g(inputs0, inputs, m, rm2, line_inpaint)
    f32 = torch.float32
    return {"coarse": coarse.to(f32), "fake": fake.to(f32),
            "mask": soft_mask, "mask_image": mask_image.to(f32),
            "mask_inpaint": m.to(f32), "line_inpaint": line_inpaint.to(f32),
            "input_inpaint": inputs0.to(f32)}


def _discriminate(net_d, fake_image, real_image, line, inputs, mask,
                  cfg: TrainConfig, update_sn: bool = False):
    """Concat-batch discrimination: (fake logits, real logits, new u or
    None); lists of logits for the multiscale discriminator."""
    cdt = cfg.dtype
    m = mask.detach()
    fake_comp = fake_image * m + real_image * (1.0 - m)
    both = torch.cat([fake_comp, real_image]).to(cdt)
    line2 = torch.cat([line, line]).to(cdt)
    cc2 = torch.cat([inputs, inputs]).to(cdt)
    out = net_d(both, line2, cc2, update_sn=update_sn)
    logits, new_u = out if update_sn else (out, None)

    def divide(t):
        t = t.float()
        n = t.shape[0] // 2
        return t[:n], t[n:]

    if isinstance(logits, list):
        pairs = [divide(t) for t in logits]
        return [f for f, _ in pairs], [r for _, r in pairs], new_u
    fake, real = divide(logits)
    return fake, real, new_u


def g_image_loss(net_d, gen, batch, cfg: TrainConfig, vgg_params=None,
                 is_real_im: bool = True):
    """The generator loss terms, by name."""
    inputs, real = batch["image"], batch["gt"]
    input_inpaint = gen["input_inpaint"]

    blur = gaussian_blur3x3 if cfg.filt_maskim else (lambda x: x)
    real_blur = blur(real)
    inputs_blur = blur(inputs)
    input_inpaint_blur = blur(input_inpaint)

    out_ims = {"coarse": gen["coarse"], "fake": gen["fake"],
               "mask": gen["mask_image"]}
    in_ims = {"coarse": input_inpaint, "fake": input_inpaint, "mask": inputs}
    blur_in_ims = {"coarse": input_inpaint_blur, "fake": input_inpaint_blur,
                   "mask": inputs_blur}
    com_masks = {"coarse": gen["mask_inpaint"], "fake": gen["mask_inpaint"],
                 "mask": gen["mask"]}
    com_ims = {k: out_ims[k] * com_masks[k] + in_ims[k] * (1 - com_masks[k])
               for k in out_ims}
    blur_com_ims = {k: out_ims[k] * com_masks[k]
                    + blur_in_ims[k] * (1 - com_masks[k]) for k in out_ims}

    G = {}
    if not cfg.train_mask_only and not cfg.no_gan_loss and is_real_im:
        pred_fake, _pred_real, _ = _discriminate(
            net_d, com_ims["fake"], real, gen["line_inpaint"], inputs,
            gen["mask_inpaint"], cfg)
        G["GAN"] = losses.gan_loss(pred_fake, True, mode=cfg.gan_mode,
                                   for_discriminator=False)

    if (not cfg.train_mask_only and not cfg.no_vgg_loss
            and vgg_params is not None and is_real_im):
        G["VGG"] = losses.vgg_loss(
            vgg_params, out_ims["fake"], real,
            imagenet_norm=cfg.vgg_imagenet_norm) * cfg.lambda_vgg

    l1c = 0.0
    if not cfg.train_mask_only and is_real_im:
        l1c = losses.l1_loss(out_ims["coarse"], real) * cfg.lambda_l1
        if cfg.update_part in ("all", "fine"):
            G["L1f"] = losses.l1_loss(out_ims["fake"], real) * cfg.lambda_l1
    l1c = l1c + losses.l1_loss(out_ims["mask"], real_blur) * cfg.lambda_l1_mask
    if not cfg.train_maskim:
        l1c = l1c + (losses.l1_loss(blur_com_ims["mask"], real_blur)
                     * cfg.lambda_l1_mask)
    G["L1c"] = l1c
    if cfg.lambda_mask_rec and "region_gt" in batch:
        G["Mrec"] = (losses.mask_bce_loss(gen["mask"], batch["region_gt"])
                     * cfg.lambda_mask_rec)
    return G


def d_loss_from_gen(net_d, gen, batch, cfg: TrainConfig):
    """Discriminator loss on an already detached generated batch; returns
    (loss, (d_fake, d_real, new u))."""
    composed = (gen["fake"] * gen["mask_inpaint"]
                + gen["input_inpaint"] * (1 - gen["mask_inpaint"]))
    pred_fake, pred_real, new_u = _discriminate(
        net_d, composed, batch["gt"], gen["line_inpaint"], batch["image"],
        gen["mask_inpaint"], cfg, update_sn=True)
    d_fake = losses.gan_loss(pred_fake, False, mode=cfg.gan_mode)
    d_real = losses.gan_loss(pred_real, True, mode=cfg.gan_mode)
    return d_fake + d_real, (d_fake, d_real, new_u)


def d_loss_fn(net_d, net_m, net_g, batch, flag: int, cfg: TrainConfig):
    """Discriminator loss with the fakes regenerated without gradient under
    their own branch flag."""
    with torch.no_grad():
        gen = generate_fake_train(net_m, net_g, batch, flag, cfg)
    return d_loss_from_gen(net_d, gen, batch, cfg)


def batch_to_device(batch, device) -> dict:
    """The numpy arrays of a loader batch as tensors on ``device`` (pinned,
    asynchronous copies on CUDA); other entries are dropped."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(v))
            out[k] = (t.pin_memory().to(device, non_blocking=True)
                      if device.type == "cuda" else t)
        elif isinstance(v, torch.Tensor):
            out[k] = v.to(device)
    return out


def decompress_batch(batch) -> dict:
    """NHWC tensors in the float or the compact protocol (uint8 'image' in
    [0, 255] with 'gt' omitted, bool masks) -> NCHW float32, 'gt' aliasing
    'image' when absent."""
    out = dict(batch)
    img = out.get("image")
    if img is not None and img.dtype == torch.uint8:
        out["image"] = img.float() / 127.5 - 1.0
        out.setdefault("gt", out["image"])
    gt = out.get("gt")
    if gt is not None and gt.dtype == torch.uint8:
        out["gt"] = gt.float() / 127.5 - 1.0
    for k in _MASK_KEYS:
        if k in out and out[k].dtype == torch.bool:
            out[k] = out[k].float()
    return {k: v.permute(0, 3, 1, 2).contiguous() for k, v in out.items()}


def _set_grads(params, grads):
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g


def _step_optimizer(opt, base_lr, step, cfg: TrainConfig):
    for group in opt.param_groups:
        group["lr"] = cfg.lr_at(base_lr, step)
    opt.step()


def g_step_grads(state: TrainState, batch, flag: int, cfg: TrainConfig,
                 vgg_params=None):
    """Generator losses and gradients (zero for the layers ``update_part``
    leaves out) on an NCHW float32 batch. Returns (total, losses by name,
    [(param, grad)] over netM then netG, the generated batch)."""
    nets = state.nets
    gen_fwd = generate_fake_train
    if cfg.remat:
        gen_fwd = functools.partial(torch.utils.checkpoint.checkpoint,
                                    generate_fake_train, use_reentrant=False)
    gen = gen_fwd(nets["M"], nets["G"], batch, flag, cfg)
    G = g_image_loss(nets["D"], gen, batch, cfg, vgg_params)
    g_sum = sum(G.values())
    params = [*nets["M"].parameters(), *nets["G"].parameters()]
    trainable = _grad_mask(cfg, nets)
    wanted = [p for p in params if id(p) in trainable]
    got = dict(zip(map(id, wanted), torch.autograd.grad(
        g_sum, wanted, allow_unused=True))) if wanted else {}
    return g_sum, G, [(p, got.get(id(p))) for p in params], gen


def d_step_grads(state: TrainState, batch, flag: int, cfg: TrainConfig,
                 gen=None):
    """Discriminator loss and gradients; the fakes are regenerated with the
    current generator unless ``gen`` (detached) is given. Returns (total,
    d_fake, d_real, [(param, grad)], new u)."""
    net_d = state.nets["D"]
    if gen is not None:
        d_sum, (d_fake, d_real, new_u) = d_loss_from_gen(net_d, gen, batch,
                                                         cfg)
    else:
        d_sum, (d_fake, d_real, new_u) = d_loss_fn(
            net_d, state.nets["M"], state.nets["G"], batch, flag, cfg)
    params = list(net_d.parameters())
    return d_sum, d_fake, d_real, list(zip(params, torch.autograd.grad(
        d_sum, params))), new_u


def train_step(state: TrainState, batch, flag_g: int, flag_d: int,
               cfg: TrainConfig, vgg_params=None):
    """One G+D step in place. ``batch``: NHWC tensors (float or compact
    protocol) with keys image, gt, mask (sketch), edgegt, random_mask,
    random_mask2 and optionally region_gt. Returns (state, metrics), the
    metrics as 0-d tensors (reading them waits for the device)."""
    batch = decompress_batch(batch)
    g_sum, G, g_grads, gen = g_step_grads(state, batch, flag_g, cfg,
                                          vgg_params)
    _set_grads(*zip(*g_grads))
    _step_optimizer(state.opt_g, cfg.g_lr(), state.step, cfg)

    metrics = {"G_total": g_sum.detach(),
               **{k: v.detach() for k, v in G.items()}}
    if not cfg.no_gan_loss:
        reused = ({k: v.detach() for k, v in gen.items()}
                  if cfg.reuse_fake else None)
        _d_sum, d_fake, d_real, d_grads, new_u = d_step_grads(
            state, batch, flag_d, cfg, gen=reused)
        _set_grads(*zip(*d_grads))
        _step_optimizer(state.opt_d, cfg.d_lr(), state.step, cfg)
        discriminator.load_u_(state.nets["D"], new_u)
        metrics.update(D_Fake=d_fake.detach(), D_real=d_real.detach())
    state.step += 1
    metrics["flag"] = torch.tensor(float(flag_g))
    return state, metrics
