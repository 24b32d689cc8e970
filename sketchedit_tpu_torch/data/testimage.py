"""TestImage dataset: paired (image, sketch) loading from file lists (a copy
of ``sketchedit_tpu/data/testimage.py``).

Semicolon-separable --image_dirs/--mask_dirs/--image_lists, postfix-based
pairing, image -> RGB in [-1,1], sketch -> "L" resized to the image size
then binarized (>0), optional --output_labels prefixing, output dirs
created at init.
"""

from __future__ import annotations

import os

from PIL import Image

from sketchedit_tpu_torch.data.transforms import binarize_sketch, image_to_array


class TestImageDataset:
    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.add_argument('--image_dirs', type=str, required=True)
        parser.add_argument('--mask_dirs', type=str, required=True,
                            help='directories holding the sketch/edge PNGs '
                                 '(the reference calls sketches "masks")')
        parser.add_argument('--image_postfix', type=str, default=".jpg")
        parser.add_argument('--mask_postfix', type=str, default=".png")
        parser.add_argument('--image_lists', type=str, required=True)
        parser.add_argument('--output_labels', type=str, required=False)
        parser.add_argument('--output_dir', type=str, required=True)
        parser.add_argument('--output_mask_dir', type=str, required=False)
        return parser

    def initialize(self, opt):
        self.opt = opt
        os.makedirs(opt.output_dir, exist_ok=True)
        if getattr(opt, 'output_mask_dir', None):
            os.makedirs(opt.output_mask_dir, exist_ok=True)
        self.image_paths, self.mask_paths, self.output_paths = \
            self._get_paths(opt)

    @staticmethod
    def _get_paths(opt):
        image_dirs = opt.image_dirs.split(";")
        mask_dirs = opt.mask_dirs.split(";")
        image_lists = opt.image_lists.split(";")
        labels = (opt.output_labels.split(";")
                  if getattr(opt, 'output_labels', None) else None)

        image_paths, mask_paths, output_paths = [], [], []
        for i, list_file in enumerate(image_lists):
            with open(list_file) as f:
                names = [n.strip('\n').replace(opt.image_postfix, '')
                         for n in f]
            for stem in names:
                image_paths.append(
                    os.path.join(image_dirs[i], stem + opt.image_postfix))
                mask_paths.append(
                    os.path.join(mask_dirs[i], stem + opt.mask_postfix))
                out = stem + opt.image_postfix
                output_paths.append(f"{labels[i]}_{out}" if labels else out)
        return image_paths, mask_paths, output_paths

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, index):
        image = Image.open(self.image_paths[index]).convert('RGB')
        sketch = Image.open(self.mask_paths[index])
        return {
            'image': image_to_array(image),                    # HWC [-1,1]
            'mask': binarize_sketch(sketch, image.size),       # HW1 {0,1}
            'path': self.output_paths[index],
        }
