"""Pipeline runner: options -> model (checkpoint or fresh init) -> a
callable that edits numpy batches (counterpart of ``sketchedit_tpu/runner.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sketchedit_tpu_torch.device import resolve_device
from sketchedit_tpu_torch.models import editline2
from sketchedit_tpu_torch.models.deepfill_c2 import DeepFillConfig
from sketchedit_tpu_torch.models.editline2 import EditLine2, EditLine2Config
from sketchedit_tpu_torch.params import checkpoint as ckpt


def config_from_opt(opt) -> EditLine2Config:
    return EditLine2Config(
        netg=DeepFillConfig(
            use_cam=getattr(opt, "use_cam", True),
            pool_type=getattr(opt, "pool_type", "max"),
            no_mask_cc=getattr(opt, "no_mask_cc", False),
            no_mask_coarse=getattr(opt, "no_mask_coarse", False),
            joint_train_inp=getattr(opt, "joint_train_inp", True),
            attention_impl=getattr(opt, "attention_impl", "auto"),
        ),
        precision=(None if getattr(opt, "precision", "highest") == "default"
                   else "highest"),
        compute_dtype=getattr(opt, "compute_dtype", "float32"),
    )


def set_precision(precision: str | None):
    """'highest' turns TF32 off in cuDNN convs and cuBLAS matmuls; cuDNN's
    TF32 default would put ~1e-3 of error into every float32 conv. These
    are process-wide PyTorch flags. None ('default') allows TF32."""
    allow = precision is None
    torch.backends.cudnn.allow_tf32 = allow
    torch.backends.cuda.matmul.allow_tf32 = allow


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        # pinned host buffer -> asynchronous copy on the current stream
        return t.pin_memory().to(device, non_blocking=True)
    return t


@dataclass
class EditPipeline:
    model: EditLine2
    config: EditLine2Config
    device: torch.device

    def __call__(self, image_nhwc: np.ndarray, sketch_nhw1: np.ndarray):
        """One edit batch -> numpy (composed, soft_mask), NHWC.

        uint8 inputs take ``edit_u8`` (uint8 out); float inputs in [-1, 1]
        take ``edit`` (float32 out).
        """
        image = _to_device(image_nhwc, self.device)
        sketch = _to_device(sketch_nhw1, self.device)
        with torch.inference_mode():
            if image.dtype == torch.uint8:
                composed, mask = editline2.edit_u8(self.model, image, sketch)
            else:
                composed, mask = editline2.edit(self.model, image, sketch)
                composed, mask = composed.float(), mask.float()
        return composed.cpu().numpy(), mask.cpu().numpy()


def build_pipeline(opt, *, require_checkpoint: bool = False,
                   seed: int = 0) -> EditPipeline:
    """Model on ``opt.device`` (cuda by default) from the checkpoints under
    ``opt.checkpoints_dir/opt.name``; a missing net gets a fresh init from
    ``seed`` with a WARNING, or raises under ``require_checkpoint``."""
    device = resolve_device(getattr(opt, "device", "cuda"))
    config = config_from_opt(opt)
    set_precision(config.precision)

    model = EditLine2(config, device=device)
    states, missing = ckpt.load_pipeline(opt)
    for label, state in states.items():
        getattr(model, f"net{label}").load_state_dict(state, strict=True)
    if missing:
        msg = (f"checkpoints missing for nets {missing} under "
               f"{opt.checkpoints_dir}/{opt.name} (epoch "
               f"{getattr(opt, 'which_epoch', 'latest')})")
        if require_checkpoint:
            raise FileNotFoundError(msg)
        print(f"WARNING: {msg}; using fresh init for those nets")
        editline2.init_nets_(model, missing, seed,
                             init_type=getattr(opt, "init_type", "xavier"),
                             gain=getattr(opt, "init_variance", 0.02))
    return EditPipeline(model=model.eval(), config=config, device=device)
