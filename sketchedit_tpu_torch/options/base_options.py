"""Command-line options (a copy of ``sketchedit_tpu/options/base_options.py``
with the port's execution flags).

The flag vocabulary is the reference's, so ``test_celeb.sh``'s flags run
unchanged. Added: ``--device`` (cuda unless asked for cpu). Changed:
``--attention_impl`` chooses between the CUDA kernel and the dense version.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


class BaseOptions:
    isTrain = False

    def __init__(self):
        self.initialized = False

    def initialize(self, parser):
        # experiment specifics
        parser.add_argument('--name', type=str, default='label2coco',
                            help='experiment name; decides checkpoint subdir')
        parser.add_argument('--joint_train_inp', action='store_true',
                            help='zero the guide channel of the context '
                                 'stream (released checkpoints use this)')
        parser.add_argument('--gpu_ids', type=str, default='0',
                            help='accepted for script compatibility; the '
                                 'device is chosen by --device')
        parser.add_argument('--checkpoints_dir', type=str,
                            default='./checkpoints')
        parser.add_argument('--model', type=str, default='editline2')
        parser.add_argument('--phase', type=str, default='train')

        # input/output sizes
        parser.add_argument('--batchSize', type=int, default=1)
        parser.add_argument('--preprocess_mode', type=str,
                            default='scale_width_and_crop',
                            choices=("resize_and_crop", "crop", "scale_width",
                                     "scale_width_and_crop", "scale_shortside",
                                     "scale_shortside_and_crop", "fixed",
                                     "none"))
        parser.add_argument('--load_size', type=int, default=1024)
        parser.add_argument('--crop_size', type=int, default=512)
        parser.add_argument('--aspect_ratio', type=float, default=1.0)
        parser.add_argument('--output_nc', type=int, default=3)

        # data
        parser.add_argument('--dataroot', type=str,
                            default='./datasets/cityscapes/')
        parser.add_argument('--dataset_mode', type=str, default='testimage')
        parser.add_argument('--serial_batches', action='store_true')
        parser.add_argument('--no_flip', action='store_true')
        parser.add_argument('--nThreads', default=0, type=int,
                            help='accepted for script compatibility; the '
                                 'port reads its datasets serially')
        parser.add_argument('--max_dataset_size', type=int, default=sys.maxsize)
        parser.add_argument('--load_from_opt_file', action='store_true')
        parser.add_argument('--display_winsize', type=int, default=400,
                            help='accepted for script compatibility; unused')

        # generator
        parser.add_argument('--netG', type=str, default='deepfillc2')
        parser.add_argument('--ngf', type=int, default=64)
        parser.add_argument('--init_type', type=str, default='xavier')
        parser.add_argument('--init_variance', type=float, default=0.02)
        parser.add_argument('--z_dim', type=int, default=256)

        # netG-specific flags (registered by the reference generator)
        parser.add_argument('--use_cam', action='store_true')
        parser.add_argument('--pool_type', default='avg')
        parser.add_argument('--no_mask_cc', action='store_true')
        parser.add_argument('--no_mask_coarse', action='store_true')

        # execution controls of the port
        parser.add_argument('--device', type=str, default='cuda',
                            choices=('cuda', 'cpu'),
                            help="where the nets run; 'cuda' raises when no "
                                 "GPU is visible")
        parser.add_argument('--compute_dtype', type=str, default='float32',
                            choices=('float32', 'bfloat16'),
                            help='dtype of the nets and activations')
        parser.add_argument('--precision', type=str, default='highest',
                            choices=('default', 'highest'),
                            help="'highest' turns TF32 off for convs and "
                                 "matmuls; 'default' allows it")
        parser.add_argument('--attention_impl', type=str, default='auto',
                            choices=('auto', 'dense', 'kernel'),
                            help="'auto': the CUDA kernel on the GPU, the "
                                 "dense version on the CPU")

        self.initialized = True
        return parser

    def gather_options(self):
        parser = argparse.ArgumentParser(
            formatter_class=argparse.ArgumentDefaultsHelpFormatter)
        parser = self.initialize(parser)
        opt, _ = parser.parse_known_args()

        # dataset-specific flags, resolved via the data registry
        from sketchedit_tpu_torch import data as data_mod
        parser = data_mod.get_option_setter(opt.dataset_mode)(
            parser, self.isTrain)

        opt, _ = parser.parse_known_args()
        if opt.load_from_opt_file:
            parser = self._update_defaults_from_file(parser, opt)
        opt = parser.parse_args()
        self.parser = parser
        return opt

    def save_options(self, opt):
        """Snapshot to ``opt.txt`` and ``opt.json`` in the run directory
        (what --load_from_opt_file reads back)."""
        base = os.path.join(opt.checkpoints_dir, opt.name, 'opt')
        os.makedirs(os.path.dirname(base), exist_ok=True)
        with open(base + '.txt', 'wt') as f:
            for k, v in sorted(vars(opt).items()):
                default = self.parser.get_default(k)
                note = '' if v == default else f'\t[default: {default}]'
                f.write(f'{str(k):>25}: {str(v):<30}{note}\n')
        payload = {k: v for k, v in vars(opt).items()
                   if isinstance(v, (int, float, str, bool, type(None)))}
        with open(base + '.json', 'wt') as f:
            json.dump(payload, f, indent=1)

    def _update_defaults_from_file(self, parser, opt):
        path = os.path.join(opt.checkpoints_dir, opt.name, 'opt.json')
        with open(path) as f:
            saved = json.load(f)
        known = {a.dest for a in parser._actions}
        for k, v in saved.items():
            if k in known:
                parser.set_defaults(**{k: v})
        return parser

    def print_options(self, opt):
        lines = ['----------------- Options ---------------']
        for k, v in sorted(vars(opt).items()):
            default = self.parser.get_default(k)
            note = '' if v == default else f'\t[default: {default}]'
            lines.append(f'{str(k):>25}: {str(v):<30}{note}')
        lines.append('----------------- End -------------------')
        print('\n'.join(lines))

    def parse(self):
        opt = self.gather_options()
        opt.isTrain = self.isTrain
        self.print_options(opt)
        if opt.isTrain:
            self.save_options(opt)
        opt.gpu_ids = [int(s) for s in str(opt.gpu_ids).split(',')
                       if s and int(s) >= 0]
        self.opt = opt
        return opt
