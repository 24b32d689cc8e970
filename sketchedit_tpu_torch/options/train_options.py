"""Training options (a copy of ``sketchedit_tpu/options/train_options.py``
on the port's base options, which add ``--device``).

Held-out validation (``--val_image_dir`` and the flags beside it) and
multi-GPU runs (``--data_parallel``, several ``--gpu_ids``) are registered
so that the JAX CLI's command lines parse, but the port's train CLI raises
on them: they are ROADMAP queue 1 items 11 and 12.
"""

from sketchedit_tpu_torch.options.base_options import BaseOptions


class TrainOptions(BaseOptions):
    isTrain = True

    def initialize(self, parser):
        parser = BaseOptions.initialize(self, parser)
        # schedule
        parser.add_argument('--niter', type=int, default=50,
                            help='epochs at full lr')
        parser.add_argument('--niter_decay', type=int, default=0,
                            help='epochs with linearly decaying lr')
        parser.add_argument('--continue_train', action='store_true')
        parser.add_argument('--which_epoch', type=str, default='latest')
        # optimizer (the TTUR pair)
        parser.add_argument('--lr', type=float, default=0.0002)
        parser.add_argument('--beta1', type=float, default=0.0)
        parser.add_argument('--beta2', type=float, default=0.9)
        parser.add_argument('--no_TTUR', action='store_true')
        # losses
        parser.add_argument('--gan_mode', type=str, default='hinge',
                            choices=('hinge', 'ls', 'original', 'w'))
        parser.add_argument('--lambda_l1', type=float, default=1.0)
        parser.add_argument('--lambda_l1_mask', type=float, default=1.0)
        parser.add_argument('--lambda_vgg', type=float, default=10.0)
        parser.add_argument('--lambda_mask_rec', type=float, default=0.0,
                            help='direct BCE supervision of the predicted '
                                 'soft mask vs the sampled GT region (0 = '
                                 'the reference objective)')
        parser.add_argument('--no_gan_loss', action='store_true')
        parser.add_argument('--no_vgg_loss', action='store_true')
        parser.add_argument('--vgg_imagenet_norm', type=int, default=1,
                            choices=(0, 1),
                            help='1: remap [-1,1] to ImageNet normalization '
                                 'before VGG19; 0: feed [-1,1] straight in')
        parser.add_argument('--no_ganFeat_loss', action='store_true',
                            default=True)
        parser.add_argument('--filt_maskim', action='store_true')
        parser.add_argument('--no_detach', action='store_true')
        parser.add_argument('--reuse_fake', action='store_true',
                            help='reuse the G-step fakes for the D update '
                                 '(skips the regeneration)')
        parser.add_argument('--remat', action='store_true',
                            help='recompute the generator forward in the '
                                 'backward pass (less activation memory)')
        # partial updates (get_param_list groups)
        parser.add_argument('--update_part', type=str, default='all')
        parser.add_argument('--load_pretrained_mask', type=str)
        parser.add_argument('--load_pretrained_g', type=str)
        parser.add_argument('--load_pretrained_d', type=str)
        # discriminator
        parser.add_argument('--netD', type=str, default='sngan',
                            choices=('sngan', 'multiscale'))
        parser.add_argument('--num_D', type=int, default=2,
                            help='scales for --netD multiscale')
        parser.add_argument('--ndf', type=int, default=64)
        # synthetic masks (MaskCreator)
        parser.add_argument('--path_objectshape_list', type=str)
        parser.add_argument('--path_objectshape_base', type=str)
        parser.add_argument('--not_om', action='store_true',
                            help='never use object masks')
        # data aug
        parser.add_argument('--cjit', type=float, default=None,
                            help='color-jitter strength')
        parser.add_argument('--dataset_mode_train', type=str)
        parser.add_argument('--dataset_mode_val', type=str)
        parser.add_argument('--cache_filelist_write', action='store_true',
                            help='write the recursive file listing to a '
                                 'files.list cache next to the data')
        parser.add_argument('--cache_filelist_read', action='store_true',
                            help='read the files.list cache if present')
        # held-out validation: not ported (ROADMAP queue 1 item 11)
        parser.add_argument('--val_image_dir', type=str, default='',
                            help='not ported: the port raises when set')
        parser.add_argument('--val_items', type=int, default=8)
        parser.add_argument('--val_epoch_freq', type=int, default=1)
        parser.add_argument('--val_track', type=str, default='auto',
                            choices=['auto', 'psnr', 'ssim', 'region_psnr',
                                     'region_l1', 'outside_l1', 'mask_iou'])
        parser.add_argument('--metrics_log', type=str, default='auto')
        # multi-GPU: not ported (ROADMAP queue 1 item 12)
        parser.add_argument('--data_parallel', type=int, default=0,
                            help='not ported: the port raises above 1')
        # bookkeeping (IterationCounter)
        parser.add_argument('--save_epoch_freq', type=int, default=10)
        parser.add_argument('--save_latest_freq', type=int, default=5000)
        parser.add_argument('--print_freq', type=int, default=100)
        parser.add_argument('--display_freq', type=int, default=100)
        # training defaults: TF32 allowed ('default'; pass --precision
        # highest for parity runs) and kaiming init (xavier at gain 0.02
        # underflows this norm-free stack)
        parser.set_defaults(phase='train', precision='default',
                            init_type='kaiming')
        return parser
