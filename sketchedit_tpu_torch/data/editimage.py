"""Training dataset for sketch-guided editing (a copy of
``sketchedit_tpu/data/editimage.py``).

The reference snapshot ships no training dataset ("training code coming
soon"); its model contract (editline2_model.py preprocess_input :223-242)
expects per-sample: image, gt, 'mask' = the *partial sketch*, 'edgegt' =
the full edge map, plus synthetic random masks. This dataset realizes the
paper's construction: full edges from a Canny detector, a random edit
region from MaskCreator, and the partial sketch = edges inside that region.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from sketchedit_tpu_torch.data.transforms import (
    get_params, apply_resize, crop_flip_array, color_jitter)
from sketchedit_tpu_torch.data.mask_creator import MaskCreator, external_mask
from sketchedit_tpu_torch.data.image_folder import make_dataset

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class EditImageDataset:
    @staticmethod
    def modify_commandline_options(parser, is_train):
        parser.add_argument('--train_image_dir', type=str,
                            help='directory of training images '
                                 '(recursively listed)')
        parser.add_argument('--train_image_list', type=str,
                            help='optional explicit file list')
        parser.add_argument('--canny_low', type=int, default=100)
        parser.add_argument('--canny_high', type=int, default=200)
        parser.add_argument('--decode_cache_mb', type=int, default=512,
                            help='cache decoded+resized uint8 frames across '
                                 'epochs up to this many MB total (0 '
                                 'disables; split evenly across spawned '
                                 'process workers when nThreads > 1); '
                                 'the resize stage is deterministic, so only '
                                 'crop/flip/Canny/mask synthesis stay '
                                 'per-epoch work for cached items')
        return parser

    def initialize(self, opt, seed: int = 0):
        self.opt = opt
        if getattr(opt, 'train_image_list', None):
            with open(opt.train_image_list) as f:
                self.paths = [line.strip() for line in f if line.strip()]
        else:
            self.paths = make_dataset(
                opt.train_image_dir,
                read_cache=getattr(opt, 'cache_filelist_read', False),
                write_cache=getattr(opt, 'cache_filelist_write', False),
                max_dataset_size=getattr(opt, 'max_dataset_size', None))
        self.rng = np.random.default_rng(seed)
        self.mask_creator = MaskCreator(
            getattr(opt, 'path_objectshape_list', None),
            getattr(opt, 'path_objectshape_base', None),
            rng=self.rng)
        self._cache: dict = {}
        self._cache_bytes = 0
        self._cache_cap = int(
            getattr(opt, 'decode_cache_mb', 512)) * (1 << 20)

    def __len__(self):
        return len(self.paths)

    def reseed(self, seed):
        """Deterministic per-item RNG for process workers: the loader calls
        this with (base_seed, epoch, index) before __getitem__, making
        augmentation draws independent of worker count and schedule."""
        self.rng = np.random.default_rng(seed)
        self.mask_creator.rng = self.rng

    def _edges(self, img_u8: np.ndarray) -> np.ndarray:
        gray = cv2.cvtColor(img_u8, cv2.COLOR_RGB2GRAY)
        e = cv2.Canny(gray, self.opt.canny_low, self.opt.canny_high)
        return (e > 0)[:, :, None]          # bool (compact protocol)

    def _resized_u8(self, index) -> np.ndarray:
        """Decoded + deterministically-resized frame, cached across epochs
        up to --decode_cache_mb (first-come; small datasets fit whole).
        Decode+resize is the only per-item stage whose result never
        changes, so caching it leaves crop/flip/Canny/mask synthesis as
        the entire steady-state item cost."""
        arr = self._cache.get(index)
        if arr is None:
            img = Image.open(self.paths[index]).convert('RGB')
            arr = np.asarray(apply_resize(self.opt, img), dtype=np.uint8)
            if self._cache_bytes + arr.nbytes <= self._cache_cap:
                self._cache[index] = arr
                self._cache_bytes += arr.nbytes
        return arr

    def __getitem__(self, index):
        frame = self._resized_u8(index)
        # crop bounds come from the resized frame's actual size
        # (size_is_resized: the shortside quirk makes the new_size
        # recomputation non-idempotent — see get_params)
        params = get_params(self.opt, (frame.shape[1], frame.shape[0]),
                            self.rng, size_is_resized=True)
        img_u8 = crop_flip_array(self.opt, frame, params)
        h, w = img_u8.shape[:2]

        edgegt = self._edges(img_u8)
        region = external_mask(
            self.mask_creator, h, w,
            use_object_masks=not getattr(self.opt, 'not_om', False))
        line = edgegt & (region > 0.5)[:, :, None]

        # --cjit: photometric-only, after edge extraction (edges describe
        # the un-jittered structure; a jittered binary map would be corrupt)
        img_out = img_u8
        if params.jitter is not None:
            img_j = color_jitter(Image.fromarray(img_u8), params.jitter)
            img_out = np.asarray(img_j, np.uint8)

        # Compact item protocol: uint8 image + bool masks, no duplicated
        # 'gt' — ~6x fewer bytes per item than float32 (2.56MB -> 0.44MB at
        # 256^2), which is what makes process workers and the collate path
        # cheap. data._collate expands to the standard float32 batch keys.
        return {
            'image_u8': img_out,
            'mask': line,                                 # partial sketch
            'edgegt': edgegt,                             # full edge map
            # GT region the partial sketch was cut from — the supervision
            # target for --lambda_mask_rec (the objective as shipped by the
            # reference admits a zero-mask collapse; see trainer.py).
            'region_gt': (region > 0.5)[:, :, None],
            'random_mask': external_mask(
                self.mask_creator, h, w,
                use_object_masks=not getattr(self.opt, 'not_om', False)
            ).astype(bool)[:, :, None],
            'random_mask2': external_mask(
                self.mask_creator, h, w,
                use_object_masks=not getattr(self.opt, 'not_om', False)
            ).astype(bool)[:, :, None],
            'path': os.path.basename(self.paths[index]),
        }
