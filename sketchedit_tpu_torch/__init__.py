"""SketchEdit on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of ``sketchedit_tpu``: the same networks, weights
and single-edit inference path, with the contextual-attention forward as a
hand-written CUDA kernel (``csrc/contextual_attention_fwd.cu``). Module
paths mirror ``sketchedit_tpu`` so each counterpart is easy to find.

Layout inside the package is NCHW; the public ``models.editline2.edit`` and
``edit_u8`` take and return NHWC like their JAX counterparts. Entry points
run on ``cuda`` unless the caller asks for the CPU (see ``device.py``).
"""
