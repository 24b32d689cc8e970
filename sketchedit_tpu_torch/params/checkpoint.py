"""Checkpoints (counterpart of ``sketchedit_tpu/params/checkpoint.py``).

Nets: ``{checkpoints_dir}/{name}/{epoch}_net_{M,G,D}`` in either format:

* ``.npz`` as the JAX package writes and reads it: flat keys
  ``<layer>/w`` (HWIO), ``<layer>/b`` and, for D, ``<layer>/u``, nested
  layers joined with ``/`` (``scale0/dconv1/w``);
* ``.pth``: a reference state dict, with any leading ``module.`` stripped.

Both load as a state dict for the port's modules; ``save_network`` writes
the ``.npz`` form. The full training state (parameters, both optimizers'
moments, the step and the branch-flag generator) goes to
``train_state_{step_name}.pt`` with ``torch.save``: it resumes the port
exactly, and the JAX package's Orbax state is not read.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sketchedit_tpu_torch.params.convert import (
    jax_params_to_state_dict, state_dict_to_jax_params, strip_module_prefix)


def net_path(checkpoints_dir, name, label, epoch, ext):
    return os.path.join(checkpoints_dir, name, f"{epoch}_net_{label}{ext}")


def _flatten(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, f"{prefix}{k}/"))
        else:
            flat[f"{prefix}{k}"] = v
    return flat


def load_network_path(path) -> dict[str, torch.Tensor]:
    """State dict from an explicit ``.npz`` or ``.pth`` path."""
    if path.endswith(".npz"):
        params: dict = {}
        with np.load(path) as data:
            for key in data.files:
                *layers, leaf = key.split("/")
                node = params
                for part in layers:
                    node = node.setdefault(part, {})
                node[leaf] = data[key]
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


def save_network(state_dict, label, epoch, opt):
    """Write ``{epoch}_net_{label}.npz`` in the JAX layout, and refresh the
    ``latest`` alias."""
    os.makedirs(os.path.join(opt.checkpoints_dir, opt.name), exist_ok=True)
    flat = _flatten(state_dict_to_jax_params(state_dict))
    epochs = [epoch] if str(epoch) == "latest" else [epoch, "latest"]
    for e in epochs:
        np.savez(net_path(opt.checkpoints_dir, opt.name, label, e, ".npz"),
                 **flat)


def save_pipeline(nets, epoch, opt):
    """Save every net of ``{label: module}``."""
    for label, net in nets.items():
        save_network(net.state_dict(), label, epoch, opt)


def _train_state_path(opt, step_name):
    return os.path.join(opt.checkpoints_dir, opt.name,
                        f"train_state_{step_name}.pt")


def save_train_state(state, opt, step_name="latest"):
    """Parameters, buffers, both optimizer states, the step and the flag
    generator of a ``trainer.TrainState``, written atomically."""
    path = _train_state_path(opt, step_name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = {"nets": {k: v.state_dict() for k, v in state.nets.items()},
               "opt_g": state.opt_g.state_dict(),
               "opt_d": state.opt_d.state_dict(),
               "step": state.step,
               "flag_rng": state.flag_rng.get_state()}
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_train_state(opt, state, step_name="latest") -> bool:
    """Restore a saved training state into ``state`` in place (tensors move
    to its devices); False when there is none."""
    path = _train_state_path(opt, step_name)
    if not os.path.exists(path):
        return False
    payload = torch.load(path, map_location="cpu", weights_only=True)
    for label, net in state.nets.items():
        net.load_state_dict(payload["nets"][label], strict=True)
    state.opt_g.load_state_dict(payload["opt_g"])
    state.opt_d.load_state_dict(payload["opt_d"])
    state.step = int(payload["step"])
    state.flag_rng.set_state(payload["flag_rng"])
    return True
