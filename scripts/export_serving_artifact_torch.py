"""Export a self-contained serving artifact on the PyTorch port (counterpart
of ``scripts/export_serving_artifact.py``: the same flags, with
``--device`` in place of ``--export_platforms``).

Loads the checkpoint with the standard options surface (the flags of the
infer and serve CLIs; a missing net gets a seeded fresh init with a
WARNING), traces the uint8 -> uint8 edit at a fixed (batch, size) with the
weights baked in through ``torch.export``, and writes <out> + <out>.json.
A deployment host loads it with
``sketchedit_tpu_torch.server.artifact.load_edit_artifact`` or serves it
with ``python -m sketchedit_tpu_torch.cli.serve --serve_artifact <out>``:
no model code, no checkpoint files, no converter. The artifact runs on the
device it was exported on (``--device``, the GPU by default) and bakes in
the forward kernel that the ``SKETCHEDIT_*`` switches choose now.

Example:
  python scripts/export_serving_artifact_torch.py --name celeb --use_cam \\
      --pool_type max --joint_train_inp --dataset_mode base \\
      --compute_dtype bfloat16 --precision default \\
      --export_size 256 --export_batch 1,32 --export_out celeb_256.pt2
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    from sketchedit_tpu_torch.options import parse_argv
    from sketchedit_tpu_torch.options.test_options import TestOptions
    from sketchedit_tpu_torch.runner import build_pipeline
    from sketchedit_tpu_torch.server.artifact import export_edit_artifact

    class ExportOptions(TestOptions):
        def initialize(self, parser):
            parser = TestOptions.initialize(self, parser)
            parser.add_argument("--export_size", type=int, default=256)
            parser.add_argument("--export_batch", type=str, default="1",
                                help="batch size, or a comma list ('1,8,32') "
                                     "to emit one artifact per serving "
                                     "bucket (suffix _b{N} before the "
                                     "extension)")
            parser.add_argument("--export_out", type=str,
                                default="edit_artifact.pt2")
            return parser

    opt = parse_argv(ExportOptions,
                     sys.argv[1:] if argv is None else argv)
    batches = [int(b) for b in str(opt.export_batch).split(",") if b]
    if not batches:
        # an unset shell variable ('--export_batch ""') must not exit 0
        # with nothing exported: the deploy pipeline would proceed
        raise SystemExit(
            f"--export_batch {opt.export_batch!r} names no batch sizes")
    pipe = build_pipeline(opt)
    if pipe.replicas:
        raise SystemExit("an artifact runs on one device: drop "
                         "--data_parallel and the extra --gpu_ids")
    for b in batches:
        if len(batches) == 1:
            out = opt.export_out
        else:
            root, ext = os.path.splitext(opt.export_out)
            out = f"{root}_b{b}{ext}"
        meta = export_edit_artifact(pipe.model, out, size=opt.export_size,
                                    batch=b, config=pipe.config)
        print(f"exported {out}: {meta}")


if __name__ == "__main__":
    main()
