#!/usr/bin/env python3
"""Where a frame served in a batch parts from the same frame served alone,
on the CPU.

    python3 scripts/batch_rounding_probe_torch.py [--seed 0]

The serve CLI's raw bulk request submits its frames to the batching
executor together, so a frame may run in a batch of two where the same
frame sent alone runs at B = 1 (``tests/test_torch_serve_api.py::
test_raw_bulk_request_roundtrip``: two 64^2 frames and a 90 x 160 one
letterboxed to 64^2, ``--max_batch 2``, float32, precision highest). This
builds the serve CLI's pipeline on the CPU at that size (kaiming weights
from ``--seed``, netM's and netG's scaled as chip_smoke.py and the test
scale theirs), runs
the test's three frames alone and in every batch of two, and prints one
JSON line per placement: the composite's and the mask's largest uint8
difference against the frame alone and how many values differ, and the
first leaf module (in call order) whose output for the frame differs, with
its largest difference. A last line follows one frame through netM's
packed encoder front (a function, so no module hook sees it), alone and
in a batch of two: each layer's F.conv2d, and its gate's ELU and sigmoid,
whose inputs (one half of the conv's channels) are strided in a batch of
two and contiguous at B = 1; the largest difference of each.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frame(seed, h, w):
    import numpy as np
    rs = np.random.RandomState(seed)
    return ((rs.rand(h, w, 3) * 255).astype(np.uint8),
            ((rs.rand(h, w) > 0.9) * 255).astype(np.uint8))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    import torch.nn.functional as F
    from PIL import Image

    from chip_smoke import scale_weights_
    from sketchedit_tpu_torch.cli.serve import ApiOptions
    from sketchedit_tpu_torch.models import editline2
    from sketchedit_tpu_torch.runner import build_pipeline
    from sketchedit_tpu_torch.server.letterbox import letterbox_fit

    with tempfile.TemporaryDirectory() as ck:
        sys.argv = ["serve", "--name", "x", "--checkpoints_dir", ck,
                    "--joint_train_inp", "--use_cam", "--pool_type", "max",
                    "--dataset_mode", "base", "--max_batch", "2",
                    "--edit_size", "64", "--compute_dtype", "float32",
                    "--precision", "highest", "--device", "cpu"]
        opt = ApiOptions().parse()
        pipe = build_pipeline(opt, seed=args.seed)
    editline2.init_nets_(pipe.model, ("M", "G"), args.seed,
                         init_type="kaiming")
    scale_weights_(pipe.model.netM, pipe.model.netG)
    frames = []
    for seed, (h, w) in ((6, (64, 64)), (7, (90, 160)), (8, (64, 64))):
        img, sk = frame(seed, h, w)
        if (h, w) != (64, 64):
            img, sk, _ = letterbox_fit(Image.fromarray(img),
                                       Image.fromarray(sk), 64)
        else:
            sk = sk[:, :, None]
        frames.append((img, sk))

    def run(ks):
        """The pipeline on frames ``ks``; every leaf module's outputs."""
        outs, hooks = {}, []
        for name, m in pipe.model.named_modules():
            if name and not list(m.children()):
                hooks.append(m.register_forward_hook(
                    lambda mod, i, o, name=name: outs.setdefault(
                        name, []).append(o.detach().clone())
                    if torch.is_tensor(o) else None))
        try:
            comp, mask = pipe(np.stack([frames[k][0] for k in ks]),
                              np.stack([frames[k][1] for k in ks]))
        finally:
            for h in hooks:
                h.remove()
        return comp, mask, outs

    alone = {k: run([k]) for k in range(len(frames))}
    for ks in itertools.permutations(range(len(frames)), 2):
        comp, mask, outs = run(list(ks))
        for pos, k in enumerate(ks):
            c1, m1, o1 = alone[k]
            dc = np.abs(comp[pos].astype(int) - c1[0].astype(int))
            dm = np.abs(mask[pos].astype(int) - m1[0].astype(int))
            first = None
            for name, calls in o1.items():
                for a, b in zip(calls, outs.get(name, [])):
                    if not torch.equal(a[0], b[pos]):
                        first = {"module": name, "max_abs_diff":
                                 (a[0] - b[pos]).abs().max().item()}
                        break
                if first:
                    break
            print(json.dumps({"batch": list(ks), "frame": k, "row": pos,
                              "composite_max_diff": int(dc.max()),
                              "composite_values_differ": int((dc > 0).sum()),
                              "mask_max_diff": int(dm.max()),
                              "first_leaf_that_differs": first}), flush=True)

    # netM's packed encoder front (ops/packed_tail.py), a function and not
    # a module, on the netM input of the frame alone and of the batch [1,
    # 2]: each layer an F.conv2d on the packed grid, then the gate ELU(a) *
    # sigmoid(g) on the two halves of its channels
    from sketchedit_tpu_torch.ops import packed_tail as pt
    netM, grab = pipe.model.netM, {}
    hook = netM.register_forward_pre_hook(
        lambda m, a: grab.update({a[0].shape[0]: torch.cat(a[:2], 1)}))
    run([2])
    run([1, 2])
    hook.remove()
    xs = {"alone": grab[1], "batched": grab[2]}
    row = {"front": "frame 2 alone against row 1 of the batch [1, 2]",
           "threads": torch.get_num_threads()}
    with torch.no_grad():
        for k, (layer, form) in enumerate(((netM.conv1, "s2d"),
                                           (netM.conv2_downsample,
                                            "stride2"))):
            w, b = pt.packed_params(layer, form, torch.float32)
            ys, gated = {}, {}
            for key, x in xs.items():
                if k == 0:
                    x = pt.space_to_depth2x(x)
                    ys[key] = F.conv2d(x, w, b, padding=1)
                else:
                    ys[key] = F.conv2d(F.pad(x, (1, 0, 1, 0)), w, b)
                a, g = ys[key].chunk(2, dim=1)
                gated[key] = (F.elu(a), torch.sigmoid(g))
            diff = lambda t: (t["alone"][0] - t["batched"][1]).abs().max(
                ).item()
            row[f"conv{k + 1}_conv2d_max_abs_diff"] = diff(ys)
            row[f"conv{k + 1}_elu_max_abs_diff"] = diff(
                {key: v[0] for key, v in gated.items()})
            row[f"conv{k + 1}_sigmoid_max_abs_diff"] = diff(
                {key: v[1] for key, v in gated.items()})
            row[f"conv{k + 1}_half_contiguous"] = {
                key: v[1].is_contiguous() for key, v in gated.items()}
            xs = {key: pt._gate(ys[key], layer.out_channels,
                                layer.activation) for key in ys}
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
