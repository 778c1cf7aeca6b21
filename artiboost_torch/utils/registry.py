"""Registry + config-driven builder (counterpart of
``artiboost_tpu/utils/registry.py``; reference ``anakin/utils/registry.py:4``,
``anakin/utils/builder.py:5-101``): components register under a name, and
``build_from_cfg`` constructs them from a dict with a ``TYPE`` key,
injecting ``default_args``. A type no registry knows raises ``KeyError``
naming the registry.

The port's builders inject these defaults: ``DATA_PRESET`` everywhere the
JAX package does; ``device`` for a METRIC and a DATASET (torch needs it at
construction); for a HEAD, ``INPUT_CHANNEL`` / ``INPUT_DIM`` (the
backbone's width, which flax infers and torch needs)."""
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
        return self._module_dict.get(key, None)

    def register_module(self, cls=None, *, name: Optional[str] = None):
        def _register(cls):
            key = name or cls.__name__
            if key in self._module_dict:
                raise KeyError(f"{key} is already registered in {self._name}")
            self._module_dict[key] = cls
            return cls

        if cls is None:
            return _register
        return _register(cls)

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={list(self._module_dict)})"


def build_from_cfg(cfg: Dict, registry: Registry, default_args: Optional[Dict] = None):
    """Build an object from a config dict with a ``TYPE`` key."""
    if not isinstance(cfg, dict) or "TYPE" not in cfg:
        raise KeyError(f"cfg must be a dict containing the key 'TYPE', got {cfg}")
    args = dict(cfg)
    obj_type = args.pop("TYPE")
    if isinstance(obj_type, str):
        obj_cls = registry.get(obj_type)
        if obj_cls is None:
            raise KeyError(f"{obj_type} is not in the {registry.name} registry")
    elif inspect.isclass(obj_type):
        obj_cls = obj_type
    else:
        raise TypeError(f"TYPE must be a str or class, got {type(obj_type)}")
    if default_args is not None:
        for k, v in default_args.items():
            args.setdefault(k, v)
    return obj_cls(**args)


# global registries (mirrors anakin/utils/builder.py:5-11)
MODEL = Registry("model")
BACKBONE = Registry("backbone")
HEAD = Registry("head")
LOSS = Registry("loss")
DATASET = Registry("dataset")
METRIC = Registry("metric")
# scramblers/refiners use module-level dispatch tables in
# artiboost/scrambler.py and artiboost/refiner.py, as in the JAX package


def build_model(cfg, default_args=None):
    return build_from_cfg(cfg, MODEL, default_args)


def build_backbone(cfg, default_args=None):
    return build_from_cfg(cfg, BACKBONE, default_args)


def build_head(cfg, default_args=None):
    return build_from_cfg(cfg, HEAD, default_args)


def build_loss(cfg, default_args=None):
    return build_from_cfg(cfg, LOSS, default_args)


def build_dataset(cfg, default_args=None):
    return build_from_cfg(cfg, DATASET, default_args)


def build_metric(cfg, default_args=None):
    return build_from_cfg(cfg, METRIC, default_args)
