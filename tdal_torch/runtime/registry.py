"""Name-based registries so configs stay declarative: port of
``tdal/runtime/registry.py``.

Components register under a string name; configs dispatch on a ``type`` key; the
remaining config keys become constructor kwargs (config wins over ``default_args``).
``tdal_torch.models`` fills the model registries under tdal's names on import;
``tdal_torch.data.dataset_wrappers`` registers its wrappers in ``DATASETS``.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    @property
    def module_dict(self) -> Dict[str, Any]:
        return self._module_dict

    def get(self, key: str):
        return self._module_dict.get(key)

    def register_module(self, cls=None, *, name: Optional[str] = None):
        """Decorator: @REG.register_module or @REG.register_module(name=...)."""

        def _register(obj):
            key = name or obj.__name__
            if key in self._module_dict:
                raise KeyError(f"{key} already registered in {self._name}")
            self._module_dict[key] = obj
            return obj

        if cls is not None:
            return _register(cls)
        return _register

    def __repr__(self):
        return f"Registry(name={self._name}, items={list(self._module_dict)})"


def build_from_cfg(cfg: dict, registry: Registry, default_args: Optional[dict] = None):
    """Instantiate registry[cfg['type']](**cfg-minus-type, **default_args).

    Parity: ``tdal.runtime.registry.build_from_cfg``."""
    if not isinstance(cfg, dict) or "type" not in cfg:
        raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
    args = dict(cfg)
    obj_type = args.pop("type")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type) or callable(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"type must be a str or class, got {type(obj_type)}")
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)


# tdal's registries: the eight of the models, then datasets and pipelines.
READERS = Registry("reader")
BACKBONES = Registry("backbone")
NECKS = Registry("neck")
HEADS = Registry("head")
LOSSES = Registry("loss")
DETECTORS = Registry("detector")
SECOND_STAGE = Registry("second_stage")
ROI_HEAD = Registry("roi_head")
LABELERS = Registry("labeler")
DATASETS = Registry("dataset")
PIPELINES = Registry("pipeline")
