"""Construction and loading of the port's models.

``from_config`` builds a model from a config object or dict;
``from_pretrained`` reads a checkpoint directory's ``config.json`` and its
torch weights (``model.safetensors`` or ``pytorch_model.bin``) with the
open-muse key names.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch

from .configuration import BaseConfig, load_config_dict

__all__ = ["ModelMixin", "load_state_file", "WEIGHTS_NAMES"]

WEIGHTS_NAMES = ("model.safetensors", "pytorch_model.bin")


def load_state_file(path: str) -> Dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


class ModelMixin:
    """Classmethods shared by the port's ``nn.Module`` models.  Subclasses
    set ``config_class`` and take the config as their first argument."""

    config_class = BaseConfig

    @classmethod
    def config_from_dict(cls, config_dict: Dict[str, Any]) -> BaseConfig:
        clean = {k: v for k, v in config_dict.items() if not k.startswith("_")}
        return cls.config_class.from_dict(clean)[0]

    @classmethod
    def from_config(cls, config):
        """From a config object or a ``config.json`` dict."""
        return cls(config if isinstance(config, BaseConfig) else cls.config_from_dict(config))

    @classmethod
    def from_pretrained(cls, path: str):
        """Build from ``path/config.json`` and load the torch weights beside it
        (unknown checkpoint keys such as buffers are ignored; a missing key
        raises)."""
        model = cls.from_config(load_config_dict(path))
        for name in WEIGHTS_NAMES:
            weights = os.path.join(path, name)
            if os.path.isfile(weights):
                missing, _ = model.load_state_dict(load_state_file(weights), strict=False)
                if missing:
                    raise KeyError(f"{weights} lacks {missing[:8]}")
                return model
        raise EnvironmentError(f"no model weights ({' / '.join(WEIGHTS_NAMES)}) in {path}")
