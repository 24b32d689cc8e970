import sys

from sketchedit_tpu_torch.options.base_options import BaseOptions
from sketchedit_tpu_torch.options.test_options import TestOptions
from sketchedit_tpu_torch.options.train_options import TrainOptions


def parse_argv(options_cls, argv):
    """Parse an explicit argv list (without the program name) through an
    Options class, which reads ``sys.argv``; the swap is undone even when
    parsing fails."""
    saved = sys.argv
    sys.argv = ["prog", *argv]
    try:
        return options_cls().parse()
    finally:
        sys.argv = saved


__all__ = ["BaseOptions", "TestOptions", "TrainOptions", "parse_argv"]
