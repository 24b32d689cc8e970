"""Interactive demo CLI on the port (counterpart of
``sketchedit_tpu/cli/demo.py``).

Serves the canvas sketch-editing UI on --port, using the same options
surface; --face_crop additionally enables the detect-crop-edit-paste
composite for full-body photos. The model runs on the GPU unless
--device cpu is given.

Example:
    python -m sketchedit_tpu_torch.cli.demo --name celeb --joint_train_inp \
        --use_cam --pool_type max --dataset_mode base \
        --filelist ./static/images/example.txt --port 9998
"""

from sketchedit_tpu_torch.options.test_options import TestOptions


class DemoOptions(TestOptions):
    def initialize(self, parser):
        parser = TestOptions.initialize(self, parser)
        parser.add_argument('--face_crop', action='store_true',
                            help='detect-crop-edit-paste composite for '
                                 'full-body photos (bundled average-'
                                 'face NCC localizer, sketch+skin-blob '
                                 'fallback; server/face_localizer.py)')
        # the interactive path defaults to the throughput configuration
        # (bfloat16 activations, TF32 allowed where float32 remains); the
        # batch CLI keeps float32/highest for checkpoint parity
        parser.set_defaults(dataset_mode='base',
                            compute_dtype='bfloat16',
                            precision='default')
        return parser


def main():
    opt = DemoOptions().parse()

    from sketchedit_tpu_torch.runner import build_pipeline
    from sketchedit_tpu_torch.server.demo_server import DemoApp, serve

    pipeline = build_pipeline(opt)
    app = DemoApp(pipeline, static_root="static", filelist=opt.filelist,
                  face_crop=opt.face_crop)
    serve(app, opt.port)


if __name__ == "__main__":
    main()
