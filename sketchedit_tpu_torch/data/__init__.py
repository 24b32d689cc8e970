"""Dataset registry and a serial batch loader for inference.

Counterpart of ``sketchedit_tpu/data/__init__.py`` for ``dataset_mode``
``testimage`` (and ``base``, the no-dataset default of the test options).
Batches are numpy NHWC; the last partial batch is padded with repeats of
its last sample and flagged by ``valid``, the count of real samples.
"""

from __future__ import annotations

import numpy as np

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


DATASETS = {"testimage": TestImageDataset, "base": BaseDataset}


def find_dataset_using_name(name: str):
    try:
        return DATASETS[name.lower().replace('_', '')]
    except KeyError:
        raise ValueError(f"unknown dataset_mode '{name}'; the port has "
                         f"{sorted(DATASETS)}") from None


def get_option_setter(name: str):
    return find_dataset_using_name(name).modify_commandline_options


def collate(samples, batch_size: int):
    """Stack samples, padding to ``batch_size`` with the last one."""
    n = len(samples)
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            batch[key] = np.stack(vals + [vals[-1]] * (batch_size - n))
        else:
            batch[key] = vals
    batch['valid'] = n
    return batch


def iterate_batches(dataset, batch_size: int):
    """Serial, ordered batches."""
    for start in range(0, len(dataset), batch_size):
        stop = min(start + batch_size, len(dataset))
        yield collate([dataset[i] for i in range(start, stop)], batch_size)


def create_dataloader(opt):
    cls = find_dataset_using_name(opt.dataset_mode)
    instance = cls()
    instance.initialize(opt)
    print(f"dataset [{type(instance).__name__}] of size {len(instance)} "
          "was created")
    return iterate_batches(instance, opt.batchSize)
