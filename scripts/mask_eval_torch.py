"""Evaluate netM's mask localization against sampled regions on the
PyTorch port (counterpart of ``scripts/mask_eval.py``: the same flags and
report keys, plus ``--device``).

For each item the editimage dataset draws a region and cuts the partial
sketch from the image's edges inside it; netM must recover the region from
(image, sketch) alone. Reported: soft-mask mass inside and outside the
region, and IoU at the 0.5 threshold (the operating point at which
inference feeds netG).

    python scripts/mask_eval_torch.py --checkpoints_dir ck --name run \\
        --image_dir imgs --items 16 [--report out.json] [--device cuda|cpu]
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoints_dir", required=True)
    ap.add_argument("--name", required=True)
    ap.add_argument("--image_dir", required=True)
    ap.add_argument("--items", type=int, default=16)
    ap.add_argument("--load_size", type=int, default=288)
    ap.add_argument("--crop_size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--which_epoch", default="latest",
                    help="checkpoint tag ('latest', 'best', or an epoch)")
    ap.add_argument("--report", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sketchedit_tpu_torch.data import find_dataset_using_name
    from sketchedit_tpu_torch.device import resolve_device
    from sketchedit_tpu_torch.models.md_generator import MDGenerator
    from sketchedit_tpu_torch.options import parse_argv
    from sketchedit_tpu_torch.options.train_options import TrainOptions
    from sketchedit_tpu_torch.params import checkpoint as ckpt
    from sketchedit_tpu_torch.runner import config_from_opt, set_precision

    opt_argv = [
        "--name", args.name, "--checkpoints_dir", args.checkpoints_dir,
        "--dataset_mode", "editimage", "--train_image_dir", args.image_dir,
        "--batchSize", "1", "--load_size", str(args.load_size),
        "--crop_size", str(args.crop_size), "--preprocess_mode",
        "resize_and_crop", "--serial_batches", "--not_om",
        "--compute_dtype", "float32", "--which_epoch", args.which_epoch,
        "--device", args.device]
    # restore the trained run's flags from its opt.json snapshot (explicit
    # flags above still win); save=False keeps that snapshot as it is
    if os.path.exists(os.path.join(args.checkpoints_dir, args.name,
                                   "opt.json")):
        opt_argv.append("--load_from_opt_file")
    opt = parse_argv(TrainOptions, opt_argv, save=False)

    state = ckpt.load_network("M", opt)
    if state is None:
        raise SystemExit(f"no netM checkpoint under "
                         f"{args.checkpoints_dir}/{args.name}")
    device = resolve_device(args.device)
    set_precision(config_from_opt(opt).precision)
    net_m = MDGenerator(device=device)
    net_m.load_state_dict(state, strict=True)
    net_m.eval()

    ds = find_dataset_using_name("editimage")()
    ds.initialize(opt, seed=args.seed)
    rows = []
    for i in range(min(args.items, len(ds))):
        item = ds[i]
        img = (item["image_u8"].astype(np.float32) / 127.5 - 1.0)[None]
        sketch = item["mask"].astype(np.float32)[None]
        region = item["region_gt"][..., 0]
        with torch.no_grad():
            soft, _ = net_m(
                torch.from_numpy(img).permute(0, 3, 1, 2).to(device),
                torch.from_numpy(sketch).permute(0, 3, 1, 2).to(device))
        s = soft[0, 0].float().cpu().numpy()
        hard = s > 0.5
        rows.append({
            "region_frac": float(region.mean()),
            "soft_inside": float(s[region].mean()) if region.any() else 0.0,
            # a region covering every pixel leaves ~region empty, and the
            # mean of nothing is NaN
            "soft_outside": (float(s[~region].mean())
                             if not region.all() else 0.0),
            "iou_0.5": float((hard & region).sum()
                             / max((hard | region).sum(), 1)),
        })
        print(f"item {i}: " + " ".join(
            f"{k}={v:.3f}" for k, v in rows[-1].items()))

    mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    out = {"items": len(rows), "mean": mean, "per_item": rows}
    print("MEAN:", json.dumps(mean))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(out, f, indent=1)
        print("report ->", args.report)
    return out


if __name__ == "__main__":
    main()
