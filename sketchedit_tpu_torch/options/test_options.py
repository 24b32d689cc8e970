"""Test/inference options (a copy of ``sketchedit_tpu/options/test_options.py``)."""

from sketchedit_tpu_torch.options.base_options import BaseOptions


class TestOptions(BaseOptions):
    isTrain = False

    def initialize(self, parser):
        parser = BaseOptions.initialize(self, parser)
        parser.add_argument('--port', type=int, default=9998,
                            help='demo server port')
        parser.add_argument('--filelist', type=str,
                            default='./static/images/example.txt',
                            help='demo example list')
        parser.add_argument('--results_dir', type=str, default='./results/')
        parser.add_argument('--which_epoch', type=str, default='latest')
        parser.add_argument('--how_many', type=float, default=float("inf"))
        parser.set_defaults(preprocess_mode='scale_width_and_crop',
                            crop_size=256, load_size=256,
                            display_winsize=256, dataset_mode='base',
                            serial_batches=True, no_flip=True, phase='test')
        return parser
