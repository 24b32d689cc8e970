"""Dataset registry and a serial batch loader (counterpart of
``sketchedit_tpu/data/__init__.py``) for ``dataset_mode`` ``testimage``,
``editimage`` (training) and ``base`` (no dataset).

Batches are numpy NHWC. ``collate`` is a copy of the JAX package's
``_collate``: the last partial batch is padded with repeats of its last
sample and flagged by ``valid``; items in the compact protocol (uint8
``image_u8`` and bool masks, as ``EditImageDataset`` gives them) are
expanded to float32 unless ``compact``, in which case the batch keeps the
uint8 image as ``image`` and the bool masks, and the trainer expands them
on the device. ``DataLoader`` is the JAX loader without its worker pools:
the same order (shuffled from ``seed + epoch``) and the same items.
"""

from __future__ import annotations

import numpy as np

from sketchedit_tpu_torch.data.editimage import EditImageDataset
from sketchedit_tpu_torch.data.testimage import TestImageDataset


class BaseDataset:
    """No-op dataset for entry points that read none."""

    @staticmethod
    def modify_commandline_options(parser, is_train):
        return parser

    def initialize(self, opt):
        self.opt = opt

    def __len__(self):
        return 0


DATASETS = {"testimage": TestImageDataset, "editimage": EditImageDataset,
            "base": BaseDataset}


def find_dataset_using_name(name: str):
    try:
        return DATASETS[name.lower().replace('_', '')]
    except KeyError:
        raise ValueError(f"unknown dataset_mode '{name}'; the port has "
                         f"{sorted(DATASETS)}") from None


def get_option_setter(name: str):
    return find_dataset_using_name(name).modify_commandline_options


def collate(samples, batch_size: int, compact: bool = False):
    """Stack samples, padding to ``batch_size`` with the last one; expand
    the compact protocol unless ``compact``."""
    n = len(samples)
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            vals = vals + [vals[-1]] * (batch_size - n)
            stacked = np.stack(vals)
            if stacked.dtype == bool and not compact:
                stacked = stacked.astype(np.float32)
            batch[key] = stacked
        else:
            batch[key] = list(vals)
    if 'image_u8' in batch:
        if compact:
            batch['image'] = batch.pop('image_u8')
        else:
            img = batch.pop('image_u8').astype(np.float32) / 127.5 - 1.0
            batch['image'] = img
            batch['gt'] = img
    batch['valid'] = n
    return batch


class DataLoader:
    """Ordered or shuffled batches, read serially. Each pass over it is one
    epoch; shuffling draws the order from ``seed + epoch``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 compact: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.compact = compact
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        self._epoch += 1
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        bs = self.batch_size
        for start in range(0, len(order), bs):
            idx = order[start:start + bs]
            if self.drop_last and len(idx) < bs:
                return
            yield collate([self.dataset[i] for i in idx], bs, self.compact)


def create_dataloader(opt):
    cls = find_dataset_using_name(opt.dataset_mode)
    instance = cls()
    instance.initialize(opt)
    print(f"dataset [{type(instance).__name__}] of size {len(instance)} "
          "was created")
    train = bool(getattr(opt, 'isTrain', False))
    return DataLoader(instance, batch_size=opt.batchSize,
                      shuffle=not opt.serial_batches, drop_last=train,
                      compact=train)
