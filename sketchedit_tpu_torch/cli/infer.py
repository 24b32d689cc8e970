"""Batch-inference CLI on the port (counterpart of
``sketchedit_tpu/cli/infer.py``).

    python -m sketchedit_tpu_torch.cli.infer <test_celeb.sh flags> [--device cuda]

Same flags and outputs as the JAX CLI: the composed image, denormalized to
uint8 RGB, goes to --output_dir/<name>, and the soft mask as uint8
grayscale to --output_mask_dir when given. --how_many bounds the count.
"""

import os

from sketchedit_tpu_torch import data
from sketchedit_tpu_torch.options.test_options import TestOptions
from sketchedit_tpu_torch.runner import build_pipeline
from sketchedit_tpu_torch.utils.imaging import mask2im, save_image, tensor2im


def main():
    opt = TestOptions().parse()
    pipeline = build_pipeline(opt)
    batches = data.create_dataloader(opt)

    processed = 0
    for i, batch in enumerate(batches):
        if i * opt.batchSize >= opt.how_many:
            break
        composed, mask = pipeline(batch['image'], batch['mask'])
        composed_u8 = tensor2im(composed)
        mask_u8 = mask2im(mask)
        for b in range(batch['valid']):
            path = batch['path'][b]
            print('process image... %s' % path)
            save_image(composed_u8[b], os.path.join(opt.output_dir, path))
            if getattr(opt, 'output_mask_dir', None):
                save_image(mask_u8[b],
                           os.path.join(opt.output_mask_dir, path))
            processed += 1
    print(f"done: {processed} images -> {opt.output_dir}")


if __name__ == '__main__':
    main()
