"""Quantitative edit-quality evaluation on the PyTorch port: PSNR, SSIM and
masked L1 (counterpart of ``scripts/edit_eval.py``: the same flags, modes
and report keys, plus ``--device``).

It scores a checkpoint on the editimage reconstruction task (the training
task: cut a partial sketch from a region's edges, reconstruct the image
from image and sketch):

  end-to-end     composed = edit(image, sketch): netM localizes, netG
                 synthesizes, soft-mask composite
                 (``sketchedit_tpu_torch/models/editline2.py``). Region
                 metrics use the sampled region; outside-L1 measures the
                 soft mask's leakage onto pixels that should pass through.
  --oracle_mask  feeds the sampled region to netG as the hard mask (netM
                 bypassed): inpainting quality, independent of netM.
  --comparators  also scores non-learned region fills under the oracle-
                 mask protocol (cv2 TELEA and Navier-Stokes inpainting, an
                 iterative blur-diffusion fill, an outside-mean fill): the
                 in-region baselines a trained netG must beat.

    python scripts/edit_eval_torch.py --checkpoints_dir ck --name celeb \\
        --image_dir imgs --items 32 [--oracle_mask] [--report out.json] \\
        [--device cuda|cpu]

Every batch fetches a handful of per-image scalars from the device.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

COMPARATORS = ("telea", "ns", "blur", "mean")


def _box3(a):
    """3x3 box blur, edge-replicated."""
    import numpy as np
    p = np.pad(a, ((1, 1), (1, 1), (0, 0)), mode="edge")
    return (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:] +
            p[1:-1, :-2] + p[1:-1, 1:-1] + p[1:-1, 2:] +
            p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:]) / 9.0


def classical_fill(name, img_u8, reg_hw):
    """Fill ``reg_hw`` ((H, W) bool) of ``img_u8`` from the pixels outside
    it. Returns float32 (H, W, 3) in [-1, 1], outside pixels untouched."""
    import numpy as np
    reg3 = reg_hw[:, :, None]
    if name in ("telea", "ns"):
        import cv2
        flag = cv2.INPAINT_TELEA if name == "telea" else cv2.INPAINT_NS
        out = cv2.inpaint(np.ascontiguousarray(img_u8),
                          reg_hw.astype(np.uint8), 5, flag)
        filled = out.astype(np.float32) / 127.5 - 1.0
    else:
        img = img_u8.astype(np.float32) / 127.5 - 1.0
        if reg_hw.all():                    # degenerate: nothing known
            mean = np.zeros(3, np.float32)
        else:
            mean = np.stack([img[..., c][~reg_hw].mean() for c in range(3)])
        filled = np.where(reg3, mean, img).astype(np.float32)
        if name == "blur":
            # iterative diffusion: blur, re-impose the known pixels; about
            # an image diagonal of steps, so information crosses the hole
            for _ in range(max(32, img.shape[0] // 4)):
                filled = np.where(reg3, _box3(filled), filled)
    img = img_u8.astype(np.float32) / 127.5 - 1.0
    return np.where(reg3, filled, img).astype(np.float32)


def comparator_names(spec):
    """--comparators 'a,b' or 'all' -> names; telea and ns are dropped with
    a WARNING when cv2 is missing."""
    if not spec:
        return []
    names = (list(COMPARATORS) if spec == "all"
             else [c for c in spec.split(",") if c])
    bad = set(names) - set(COMPARATORS)
    if bad:
        raise SystemExit(f"unknown comparators: {sorted(bad)}")
    if {"telea", "ns"} & set(names):
        try:
            import cv2  # noqa: F401
        except ImportError:
            print("WARNING: cv2 unavailable — dropping telea/ns")
            names = [c for c in names if c not in ("telea", "ns")]
    return names


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoints_dir", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--items", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--load_size", type=int, default=288)
    ap.add_argument("--crop_size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--compute_dtype", default="float32")
    ap.add_argument("--oracle_mask", action="store_true")
    ap.add_argument("--which_epoch", default="latest",
                    help="checkpoint tag ('latest', 'best', or an epoch)")
    ap.add_argument("--report", default=None)
    # these flags change the forward graph but not the parameter set, so a
    # mismatch with the trained config loads cleanly and scores another
    # network: the run's opt.json, when present, is restored as defaults
    # (explicit flags still win); pass them for a fresh-init baseline
    ap.add_argument("--use_cam", action="store_true")
    ap.add_argument("--joint_train_inp", action="store_true")
    ap.add_argument("--pool_type", default=None)
    ap.add_argument("--comparators", default=None,
                    help="comma list of non-learned region-fill baselines "
                         "to score alongside (telea,ns,blur,mean); "
                         "'all' = every available one")
    ap.add_argument("--require_checkpoint", action="store_true",
                    help="fail instead of falling back to fresh init "
                         "when a net's checkpoint is missing")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sketchedit_tpu_torch import runner
    from sketchedit_tpu_torch.data import find_dataset_using_name
    from sketchedit_tpu_torch.models import editline2
    from sketchedit_tpu_torch.options import parse_argv
    from sketchedit_tpu_torch.options.train_options import TrainOptions
    from sketchedit_tpu_torch.utils import metrics

    opt_argv = [
        "--name", args.name, "--checkpoints_dir", args.checkpoints_dir,
        "--dataset_mode", "editimage", "--train_image_dir", args.image_dir,
        "--batchSize", str(args.batch), "--load_size", str(args.load_size),
        "--crop_size", str(args.crop_size), "--preprocess_mode",
        "resize_and_crop", "--serial_batches", "--not_om",
        "--compute_dtype", args.compute_dtype, "--which_epoch",
        args.which_epoch, "--device", args.device]
    if args.use_cam:
        opt_argv.append("--use_cam")
    if args.joint_train_inp:
        opt_argv.append("--joint_train_inp")
    if args.pool_type is not None:
        opt_argv += ["--pool_type", args.pool_type]
    if os.path.exists(os.path.join(args.checkpoints_dir, args.name,
                                   "opt.json")):
        opt_argv.append("--load_from_opt_file")
    # save=False: keep the train run's opt snapshot
    opt = parse_argv(TrainOptions, opt_argv, save=False)

    pipe = runner.build_pipeline(
        opt, require_checkpoint=args.require_checkpoint)
    model, config, device = pipe.model, pipe.config, pipe.device

    def oracle_edit(image, sketch, region):
        dt = config.dtype
        img, sk, reg = (t.permute(0, 3, 1, 2).to(dt)
                        for t in (image, sketch, region))
        _, fake = model.netG(img, img, reg, reg, sk)
        composed = fake * reg + img * (1.0 - reg)
        return composed.permute(0, 2, 3, 1), region

    def score(image, sketch, region):
        if args.oracle_mask:
            composed, soft = oracle_edit(image, sketch, region)
        else:
            composed, soft = editline2.edit(model, image, sketch)
        return score_composed(composed, image, region, {
            "outside_l1": metrics.masked_l1(composed.float(), image,
                                            1.0 - region),
            "region_frac": region.mean(dim=(1, 2, 3)),
            "soft_mass": soft.float().mean(dim=(1, 2, 3))})

    def score_composed(composed, image, region, extra=None):
        composed = composed.float()
        out = {
            "psnr": metrics.psnr(composed, image),
            "ssim": metrics.ssim(composed, image),
            "region_psnr": metrics.masked_psnr(composed, image, region),
            "region_l1": metrics.masked_l1(composed, image, region),
            **(extra or {}),
        }
        keys = list(out)
        vals = torch.stack([out[k] for k in keys]).cpu().numpy()
        return dict(zip(keys, vals))

    comp_names = comparator_names(args.comparators)

    ds = find_dataset_using_name("editimage")()
    ds.initialize(opt, seed=args.seed)
    n_items = min(args.items, len(ds))
    if n_items == 0:
        raise SystemExit(f"no images under {args.image_dir}")

    def on_device(arrays):
        return torch.from_numpy(np.stack(arrays)).to(device)

    rows = []
    comp_rows = {c: [] for c in comp_names}
    for start in range(0, n_items, args.batch):
        idx = list(range(start, min(start + args.batch, n_items)))
        items = [ds[i % len(ds)] for i in idx]
        while len(items) < args.batch:      # pad the last batch, sliced below
            items.append(items[-1])
        image = on_device([it["image_u8"].astype(np.float32) / 127.5 - 1.0
                           for it in items])
        sketch = on_device([it["mask"].astype(np.float32) for it in items])
        region = on_device([it["region_gt"].astype(np.float32)
                            for it in items])
        with torch.no_grad():
            out = score(image, sketch, region)
        out = {k: v[:len(idx)] for k, v in out.items()}
        for j in range(len(idx)):
            rows.append({k: float(v[j]) for k, v in out.items()})
        print(f"items {idx[0]}..{idx[-1]}: " + " ".join(
            f"{k}={out[k].mean():.3f}" for k in
            ("psnr", "ssim", "region_psnr", "region_l1", "outside_l1")))
        for c in comp_names:
            filled = on_device([classical_fill(
                c, it["image_u8"], np.asarray(it["region_gt"][:, :, 0], bool))
                for it in items])
            with torch.no_grad():
                cout = score_composed(filled, image, region)
            for j in range(len(idx)):
                comp_rows[c].append({k: float(v[j]) for k, v in cout.items()})

    mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    result = {"mode": "oracle_mask" if args.oracle_mask else "end_to_end",
              "items": len(rows), "crop_size": args.crop_size,
              "mean": mean, "per_item": rows}
    if comp_names:
        result["comparators"] = {
            c: {"mean": {k: float(np.mean([r[k] for r in comp_rows[c]]))
                         for k in comp_rows[c][0]},
                "per_item": comp_rows[c]}
            for c in comp_names}
    print("MEAN:", json.dumps(mean))
    for c in comp_names:
        print(f"COMPARATOR {c}:",
              json.dumps(result["comparators"][c]["mean"]))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(result, f, indent=1)
        print("report ->", args.report)
    return result


if __name__ == "__main__":
    main()
