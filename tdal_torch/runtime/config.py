"""Executable-Python config system with attribute-dict access.

A copy of ``tdal/runtime/config.py``: ``Config.fromfile`` over .py/.json/.yaml
(Python configs run as a module, like the reference's det3d/torchie/utils/
config.py:51-161), attribute access through the recursive ``ConfigDict``, and the
dotted-key CLI merge.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, Mapping


class ConfigDict(dict):
    """dict with attribute access, recursively wrapping nested mappings."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        d = dict(*args, **kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, ConfigDict):
            return value
        if isinstance(value, Mapping):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def get(self, key, default=None):
        v = super().get(key, default)
        return v

    def copy(self) -> "ConfigDict":
        return ConfigDict(self)


class Config:
    """A loaded config: ``Config.fromfile(path)`` -> attr-dict of module-level names.

    Python configs are executed as a module (like the reference's, so configs can
    compute derived fields); json/yaml are parsed. ``text`` keeps the raw source for
    logging/checkpoint metadata (reference Config.text, config.py:117)."""

    def __init__(self, cfg_dict: dict | None = None, filename: str | None = None, text: str = ""):
        self._cfg_dict = ConfigDict(cfg_dict or {})
        self._filename = filename
        self._text = text

    @staticmethod
    def fromfile(filename: str | os.PathLike) -> "Config":
        path = Path(filename).expanduser().resolve()
        if not path.exists():
            raise FileNotFoundError(str(path))
        suffix = path.suffix
        if suffix == ".py":
            spec = importlib.util.spec_from_file_location(
                f"_tdal_torch_cfg_{path.stem}_{abs(hash(str(path)))}", str(path)
            )
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            try:
                spec.loader.exec_module(mod)
                cfg_dict = {
                    k: v
                    for k, v in vars(mod).items()
                    if not k.startswith("__") and not callable(v)
                    and not isinstance(v, type(sys))
                }
            finally:
                sys.modules.pop(spec.name, None)
        elif suffix == ".json":
            cfg_dict = json.loads(path.read_text())
        elif suffix in (".yml", ".yaml"):
            import yaml

            cfg_dict = yaml.safe_load(path.read_text())
        else:
            raise OSError(f"Only py/json/yml/yaml configs are supported, got {suffix}")
        return Config(cfg_dict, filename=str(path), text=path.read_text())

    @property
    def filename(self):
        return self._filename

    @property
    def text(self):
        return self._text

    def __getattr__(self, name):
        return getattr(self._cfg_dict, name)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __setattr__(self, name, value):
        if name.startswith("_"):
            super().__setattr__(name, value)
        else:
            self._cfg_dict[name] = value

    def __contains__(self, name):
        return name in self._cfg_dict

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def to_dict(self) -> dict:
        def unwrap(v: Any):
            if isinstance(v, ConfigDict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return {k: unwrap(v) for k, v in self._cfg_dict.items()}

    def merge_from_dict(self, options: Mapping[str, Any]):
        """Merge flat dotted-key overrides, e.g. {'optimizer.lr': 1e-3}.

        Parity with the CLI-override merge in reference tools/train.py:74-91."""
        for full_key, v in options.items():
            d = self._cfg_dict
            keys = full_key.split(".")
            for k in keys[:-1]:
                if k not in d:
                    d[k] = ConfigDict()
                d = d[k]
            d[keys[-1]] = v
