"""Construction, saving and loading of the port's models.

``from_config`` builds a model from a config object or dict;
``from_pretrained`` reads a checkpoint directory's ``config.json`` and its
torch weights (``model.safetensors`` or ``pytorch_model.bin``) with the
open-muse key names, or the JAX package's own ``save_pretrained`` weights
(``flax_model.safetensors``, the flax tree mapped by
``convert.jax_params_to_state_dict``), onto a device (the card unless the
caller asks for the CPU); ``save_pretrained`` writes the torch format, which
the JAX package's ``from_pretrained`` reads too.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict

import torch

from .configuration import CONFIG_NAME, BaseConfig, load_config_dict

__all__ = ["ModelMixin", "load_state_file", "resolve_device", "WEIGHTS_NAMES"]

WEIGHTS_NAMES = ("model.safetensors", "pytorch_model.bin")
FLAX_WEIGHTS_NAME = "flax_model.safetensors"  # the JAX package's save_pretrained


def load_state_file(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present (the port's entry points never fall back to the
    CPU by themselves)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but CUDA is not available; "
                           f"pass device='cpu' to run on the CPU")
    return device


def _flax_state_dict(path: str, model) -> Dict[str, torch.Tensor]:
    """The port state_dict of a ``flax_model.safetensors`` file (the flat
    flax tree, '.'-joined paths); raises on a leaf no port key takes."""
    from safetensors.numpy import load_file

    from .convert import jax_params_to_state_dict

    state, unused = jax_params_to_state_dict(load_file(path), model)
    if unused:
        raise KeyError(f"{path}: no port key for {unused[:8]}")
    return state


class ModelMixin:
    """Classmethods shared by the port's ``nn.Module`` models.  Subclasses
    set ``config_class``, ``_class_name`` (the class name written to and
    read from ``config.json``, as the JAX package and open-muse name it) and
    take the config as their first argument."""

    config_class = BaseConfig
    _class_name = None
    _extra_config: Dict[str, Any] = {}  # written to config.json beside the fields

    @classmethod
    def config_from_dict(cls, config_dict: Dict[str, Any]) -> BaseConfig:
        clean = {k: v for k, v in config_dict.items() if not k.startswith("_")}
        return cls.config_class.from_dict(clean)[0]

    @classmethod
    def from_config(cls, config):
        """From a config object or a ``config.json`` dict."""
        return cls(config if isinstance(config, BaseConfig) else cls.config_from_dict(config))

    @classmethod
    def from_pretrained(cls, path: str, device="cuda"):
        """Build on ``device`` from ``path/config.json`` and load the torch
        weights beside it (unknown checkpoint keys such as buffers are
        ignored; a missing key raises), else the JAX package's flax weights
        (every leaf must map to one port key).  Raises when ``device`` is
        CUDA and there is none."""
        device = resolve_device(device)
        for name in (*WEIGHTS_NAMES, FLAX_WEIGHTS_NAME):
            weights = os.path.join(path, name)
            if os.path.isfile(weights):
                with torch.device(device):
                    model = cls.from_config(load_config_dict(path))
                if name == FLAX_WEIGHTS_NAME:
                    model.load_state_dict(_flax_state_dict(weights, model))
                    return model
                missing, _ = model.load_state_dict(load_state_file(weights), strict=False)
                if missing:
                    raise KeyError(f"{weights} lacks {missing[:8]}")
                return model
        raise EnvironmentError(f"no model weights ({' / '.join(WEIGHTS_NAMES)} / "
                               f"{FLAX_WEIGHTS_NAME}) in {path}")

    def save_pretrained(self, save_directory: str) -> None:
        """Write ``config.json`` (the config's fields and ``_class_name``) and
        ``model.safetensors`` (the state_dict, open-muse key names)."""
        from safetensors.torch import save_file

        os.makedirs(save_directory, exist_ok=True)
        config_dict = dataclasses.asdict(self.config)
        config_dict.update(self._extra_config)
        config_dict["_class_name"] = self._class_name or type(self).__name__
        with open(os.path.join(save_directory, CONFIG_NAME), "w", encoding="utf-8") as f:
            json.dump(config_dict, f, indent=2, sort_keys=True)
        save_file({k: v.detach().cpu().contiguous() for k, v in self.state_dict().items()},
                  os.path.join(save_directory, WEIGHTS_NAMES[0]))
