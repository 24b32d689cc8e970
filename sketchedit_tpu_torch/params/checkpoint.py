"""Checkpoint loading (counterpart of ``sketchedit_tpu/params/checkpoint.py``).

Reads ``{checkpoints_dir}/{name}/{epoch}_net_{M,G}`` in either format:

* ``.npz`` as the JAX package writes it: flat keys ``<layer>/w`` (HWIO) and
  ``<layer>/b``;
* ``.pth``: a reference state dict, with any leading ``module.`` stripped.

Both come back as a state dict for the port's modules.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sketchedit_tpu_torch.params.convert import (
    jax_params_to_state_dict, strip_module_prefix)


def net_path(checkpoints_dir, name, label, epoch, ext):
    return os.path.join(checkpoints_dir, name, f"{epoch}_net_{label}{ext}")


def load_network_path(path) -> dict[str, torch.Tensor]:
    """State dict from an explicit ``.npz`` or ``.pth`` path."""
    if path.endswith(".npz"):
        params: dict = {}
        with np.load(path) as data:
            for key in data.files:
                layer, leaf = key.rsplit("/", 1)
                params.setdefault(layer, {})[leaf] = data[key]
        return jax_params_to_state_dict(params)
    state = torch.load(path, map_location="cpu", weights_only=True)
    return strip_module_prefix(state)


def load_network(label, opt):
    """State dict of net ``label`` at ``opt.which_epoch``, or None when
    neither file exists."""
    epoch = getattr(opt, "which_epoch", "latest")
    for ext in (".npz", ".pth"):
        path = net_path(opt.checkpoints_dir, opt.name, label, epoch, ext)
        if os.path.exists(path):
            return load_network_path(path)
    return None


def load_pipeline(opt):
    """Returns ({label: state dict}, missing labels) for netM and netG."""
    states, missing = {}, []
    for label in ("M", "G"):
        state = load_network(label, opt)
        if state is None:
            missing.append(label)
        else:
            states[label] = state
    return states, missing
