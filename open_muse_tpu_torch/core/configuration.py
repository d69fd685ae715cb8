"""Frozen dataclass configs and a reader for open-muse ``config.json`` files.

Counterpart of ``open_muse_tpu/core/configuration.py``: the same field names
and defaults, the same on-disk format, and no jax.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple

__all__ = ["BaseConfig", "load_config_dict", "CONFIG_NAME"]

CONFIG_NAME = "config.json"


# a field's type as ``from __future__ import annotations`` leaves it: a string
_FLOAT_TYPES = ("float", "Optional[float]")


def _freeze(value):
    """JSON lists become tuples so configs stay hashable."""
    if isinstance(value, list):
        return tuple(_freeze(v) for v in value)
    return value


@dataclasses.dataclass(frozen=True)
class BaseConfig:
    @classmethod
    def from_dict(cls, config_dict: Dict[str, Any]) -> Tuple["BaseConfig", Dict[str, Any]]:
        """(config, unused keys): unknown keys such as ``_class_name`` are
        returned, not fatal.  A string given for a float field is read as a
        number (YAML 1.1 reads ``1e-6`` as a string)."""
        types = {f.name: f.type for f in dataclasses.fields(cls)}
        names = set(types)
        used = {k: float(v) if isinstance(v, str) and types[k] in _FLOAT_TYPES else _freeze(v)
                for k, v in config_dict.items() if k in names}
        unused = {k: v for k, v in config_dict.items() if k not in names}
        return cls(**used), unused

    def replace(self, **changes) -> "BaseConfig":
        return dataclasses.replace(self, **{k: _freeze(v) for k, v in changes.items()})


def load_config_dict(path: str) -> Dict[str, Any]:
    """Read ``config.json`` from a local checkpoint directory."""
    config_file = os.path.join(path, CONFIG_NAME)
    if not os.path.isfile(config_file):
        raise EnvironmentError(f"{path} does not contain a {CONFIG_NAME} file")
    with open(config_file, "r", encoding="utf-8") as f:
        return json.load(f)
