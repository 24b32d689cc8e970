"""The plain reference of the first G+D training steps.

The released step (SketchEdit's ``editline2`` model with ``deepfillc2`` and
``sngan``): the generator loss is the hinge GAN term, the VGG19 perceptual
loss (x10), L1 on the fine output and, as L1c, on the coarse output, the
mask image and the mask image composited with netM's soft mask; netM and
netG take one Adam step (lr/2, betas (0, 0.9), eps 1e-8), then the fakes
are made again with the updated nets under the discriminator's own branch
flag and netD takes its hinge step (lr*2), its power-iteration vectors
written back after it. Branch flags: 0 inpaints a random rectangle with
the full edge map, 1 takes netM's soft mask (detached), 2 its hard mask.

Returns what the harness compares: each step's generator and
discriminator loss, each leaf's first gradient norm, and each leaf's
change over the steps. Leaves are named ``<net>.<layer>.<weight|bias>``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import nets
from benchmark.reference.precision import FLOAT32, plain_float32


def decompress(batch: dict) -> dict:
    """A compact NHWC batch (uint8 image, bool masks) as NCHW float32."""
    image = batch["image"].float() / 127.5 - 1.0
    out = {"image": image, "gt": image}
    for k in ("mask", "edgegt", "random_mask", "random_mask2"):
        out[k] = batch[k].float()
    return {k: v.permute(0, 3, 1, 2).contiguous() for k, v in out.items()}


def generate(P, batch, flag, threshold, q, hard=None):
    """``hard``: the hard mask to take under flag 2 in place of netM's
    thresholded one (the program's, which the check follows)."""
    inputs, real, line = batch["image"], batch["gt"], batch["mask"]
    soft, mask_image = nets.net_m(P["M"], inputs, line, q)
    if flag == 0:
        m = batch["random_mask"]
        line_inpaint, inputs0 = batch["edgegt"] * m, real
    elif flag == 1:
        m = soft.detach()
        line_inpaint, inputs0 = line, inputs
    else:
        m = (soft > threshold).float()
        if hard is not None:        # rows past the given mask's keep m
            m = torch.cat([hard.float().detach()[:len(m)], m[len(hard):]])
        line_inpaint, inputs0 = line, inputs
    rm2 = (1.0 - batch["random_mask2"]) * m
    coarse, fake = nets.net_g(P["G"], inputs0, inputs, m, rm2, line_inpaint, q)
    return {"coarse": coarse, "fake": fake, "soft": soft,
            "mask_image": mask_image, "m": m, "line": line_inpaint,
            "inputs0": inputs0}


def discriminate(P, fake, real, line, cc, m, q):
    m = m.detach()
    both = torch.cat([fake * m + real * (1.0 - m), real])
    logits, new_u = nets.net_d(P["D"], both, torch.cat([line, line]),
                               torch.cat([cc, cc]), q)
    n = logits.shape[0] // 2
    return logits[:n], logits[n:], new_u


def l1(a, b):
    return (a - b).abs().mean()


def g_loss(P, vgg, gen, batch, hp, q):
    real, inputs = batch["gt"], batch["image"]
    m = gen["m"]
    com_fake = gen["fake"] * m + gen["inputs0"] * (1.0 - m)
    pred_fake, _, _ = discriminate(P, com_fake, real, gen["line"], inputs, m,
                                   q)
    fx = nets.vgg_features(vgg, gen["fake"], q)
    with torch.no_grad():
        fy = nets.vgg_features(vgg, real, q)
    vgg_l = sum(w * l1(a, b) for w, a, b in
                zip(nets.VGG_TAP_WEIGHTS, fx, fy))
    soft = gen["soft"]
    com_mask = gen["mask_image"] * soft + inputs * (1.0 - soft)
    l1c = (l1(gen["coarse"], real) * hp["lambda_l1"]
           + l1(gen["mask_image"], real) * hp["lambda_l1_mask"]
           + l1(com_mask, real) * hp["lambda_l1_mask"])
    return (-pred_fake.mean() + vgg_l * hp["lambda_vgg"]
            + l1(gen["fake"], real) * hp["lambda_l1"] + l1c)


def d_loss(P, gen, batch, q):
    m = gen["m"]
    composed = gen["fake"] * m + gen["inputs0"] * (1.0 - m)
    pred_fake, pred_real, new_u = discriminate(
        P, composed, batch["gt"], gen["line"], batch["image"], m, q)
    return F.relu(1.0 + pred_fake).mean() + F.relu(1.0 - pred_real).mean(), \
        new_u


def leaves(P, nets_):
    return {f"{n}.{k}": v for n in nets_ for k, v in P[n].items()
            if not k.endswith(".u")}


def train_steps(weights, vgg, batches, flags, hp, q=FLOAT32, hard=None):
    """``weights``: {'M', 'G', 'D': {name: tensor}} (copied, not changed);
    ``vgg``: [(weight, bias)]; ``batches``: compact NHWC batches, one per
    step; ``flags``: (G flag, D flag) per step; ``hard``: per call of
    netG (the G step's, then the D step's, of each step) the hard mask to
    follow under flag 2, or None. Returns {'losses': [(G total, D
    total)], 'grad': {leaf: first gradient norm}, 'change': {leaf: norm of
    its change over the steps}, 'soft': the first call's soft mask,
    'hard': the hard mask of each call under flag 2 (else None)}."""
    with plain_float32():
        P = {n: {k: v.detach().float().clone().requires_grad_(
                    not k.endswith(".u"))
                 for k, v in w.items()} for n, w in weights.items()}
        start = {k: v.detach().clone() for k, v in leaves(P, "MGD").items()}
        gen_leaves = leaves(P, "MG")
        d_leaves = leaves(P, "D")
        betas = (hp["beta1"], hp["beta2"])
        opt_g = torch.optim.Adam(list(gen_leaves.values()), lr=hp["lr"] / 2,
                                 betas=betas, eps=1e-8, foreach=False)
        opt_d = torch.optim.Adam(list(d_leaves.values()), lr=hp["lr"] * 2,
                                 betas=betas, eps=1e-8, foreach=False)
        out = {"losses": [], "grad": {}, "hard": []}
        follow = list(hard) if hard is not None else [None] * (2 * len(flags))
        for i, (batch, (flag_g, flag_d)) in enumerate(zip(batches, flags)):
            batch = decompress(batch)
            gen = generate(P, batch, flag_g, hp["mask_threshold"], q,
                           follow[2 * i])
            out["hard"].append(gen["m"].detach() if flag_g == 2 else None)
            if i == 0:
                out["soft"] = gen["soft"].detach()
            g_sum = g_loss(P, vgg, gen, batch, hp, q)
            grads = torch.autograd.grad(g_sum, list(gen_leaves.values()),
                                        allow_unused=True)
            for p, g in zip(gen_leaves.values(), grads):
                p.grad = torch.zeros_like(p) if g is None else g
            opt_g.step()
            del gen
            with torch.no_grad():
                gen = generate(P, batch, flag_d, hp["mask_threshold"], q,
                               follow[2 * i + 1])
            out["hard"].append(gen["m"] if flag_d == 2 else None)
            d_sum, new_u = d_loss(P, gen, batch, q)
            d_grads = torch.autograd.grad(d_sum, list(d_leaves.values()))
            for p, g in zip(d_leaves.values(), d_grads):
                p.grad = g
            opt_d.step()
            with torch.no_grad():
                for name, u in new_u.items():
                    P["D"][f"{name}.u"].copy_(u)
            if i == 0:
                out["grad"] = {k: p.grad.norm().item() for k, p in
                               {**gen_leaves, **d_leaves}.items()}
            out["losses"].append((g_sum.item(), d_sum.item()))
            del gen, g_sum, d_sum, grads, d_grads
        out["change"] = {k: (v.detach() - start[k]).norm().item()
                         for k, v in leaves(P, "MGD").items()}
    return out
