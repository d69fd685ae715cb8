"""Experiment configs: YAML + command-line dot overrides + ``${a.b}``
interpolation.

The port's own copy of ``open_muse_tpu/utils/config.py`` (an OmegaConf
subset): the same file format and override syntax, so the trainer reads the
same ``configs/*.yaml`` and command lines.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional

import yaml

__all__ = ["Config", "merge", "parse_cli", "load_config"]

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


class Config:
    """Attribute-accessible nested dict."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_data", {})
        for k, v in (data or {}).items():
            self._data[k] = Config(v) if isinstance(v, dict) else v

    def __getattr__(self, name):
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        raise AttributeError(f"config has no key {name!r}")

    def __setattr__(self, name, value):
        self._data[name] = Config(value) if isinstance(value, dict) else value

    def __getitem__(self, name):
        return self._data[name]

    def __setitem__(self, name, value):
        self.__setattr__(name, value)

    def __contains__(self, name):
        return name in self._data

    def __iter__(self):
        return iter(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, name, default=None):
        return self._data.get(name, default)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v.to_dict() if isinstance(v, Config) else v
                for k, v in self._data.items()}

    def __repr__(self):
        return f"Config({json.dumps(self.to_dict(), default=str, indent=2)})"

    def set_dotted(self, path: str, value):
        parts = path.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node._data.get(p), Config):
                node._data[p] = Config()
            node = node._data[p]
        node._data[parts[-1]] = Config(value) if isinstance(value, dict) else value

    def get_dotted(self, path: str, default=None):
        node = self
        for p in path.split("."):
            if not isinstance(node, Config) or p not in node:
                return default
            node = node._data[p]
        return node


def _parse_value(text: str):
    """YAML scalar parsing for command-line override values."""
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _resolve_interpolations(cfg: Config) -> Config:
    def resolve(value):
        if isinstance(value, str):
            def sub(m):
                ref = cfg.get_dotted(m.group(1))
                if ref is None:
                    raise KeyError(f"interpolation ${{{m.group(1)}}} not found")
                return str(ref)

            whole = _INTERP_RE.fullmatch(value)
            if whole:  # a whole-string interpolation keeps the referenced type
                return cfg.get_dotted(whole.group(1))
            return _INTERP_RE.sub(sub, value)
        return value

    def walk(node):
        for k, v in list(node._data.items()):
            if isinstance(v, Config):
                walk(v)
            else:
                node._data[k] = resolve(v)

    walk(cfg)  # two passes resolve chained interpolations
    walk(cfg)
    return cfg


def merge(base: Config, override: Config) -> Config:
    for k, v in override._data.items():
        if k in base._data and isinstance(base._data[k], Config) and isinstance(v, Config):
            merge(base._data[k], v)
        else:
            base._data[k] = v
    return base


def parse_cli(argv: List[str]) -> Config:
    """['a.b=1', 'config=path.yaml'] -> Config."""
    cfg = Config()
    for arg in argv:
        if "=" not in arg:
            raise ValueError(f"command-line override {arg!r} must be key=value")
        key, _, value = arg.partition("=")
        cfg.set_dotted(key.strip(), _parse_value(value.strip()))
    return cfg


def load_config(argv: List[str]) -> Config:
    """Load the YAML named by ``config=``, merge the dot overrides on top and
    resolve ``${}`` interpolations."""
    cli = parse_cli(argv)
    yaml_path = cli.get("config")
    if yaml_path is None:
        raise ValueError("pass config=path/to/config.yaml")
    with open(yaml_path) as f:
        base = Config(yaml.safe_load(f))
    return _resolve_interpolations(merge(base, cli))
