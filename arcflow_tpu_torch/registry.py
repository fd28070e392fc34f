"""Name -> constructor registries for config-driven construction.

The port's own copy of ``arcflow_tpu/registry.py``: every component is built
from a ``dict(type='Name', **kwargs)`` config. ``MODELS`` holds the
top-level compositions, ``MODULES`` the diffusion math, denoisers, losses
and timestep samplers, ``HOOKS`` the runner hooks, ``DATASETS`` the
datasets and ``SCHEDULERS`` the inference-time flow schedulers. Names are
the JAX package's, so one config builds either package. The registries
fill as ``arcflow_tpu_torch``'s subpackages are imported; the package's
``__init__`` imports them all.
"""

from __future__ import annotations

import copy
import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A flat name -> constructor mapping with ``build``."""

    def __init__(self, name: str):
        self.name = name
        self._module_dict: Dict[str, Callable] = {}

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f'Registry(name={self.name}, items={list(self._module_dict)})'

    def keys(self):
        return self._module_dict.keys()

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, name: Optional[str] = None,
                        module: Optional[Callable] = None,
                        force: bool = False):
        """Register a class or function, usable as a decorator."""
        if module is not None:
            self._register(module, name, force)
            return module

        def _decorator(cls):
            self._register(cls, name, force)
            return cls

        return _decorator

    def _register(self, module: Callable, name: Optional[str], force: bool):
        key = name or module.__name__
        if not force and key in self._module_dict:
            raise KeyError(f'{key} is already registered in {self.name}')
        self._module_dict[key] = module

    def build(self, cfg: Any, default_args: Optional[dict] = None):
        """Construct an object from ``dict(type='Name', **kwargs)``; keys of
        ``default_args`` the config does not set are added. Non-dict configs
        (already-built objects, None) pass through unchanged."""
        if cfg is None or not isinstance(cfg, dict):
            return cfg
        cfg = copy.deepcopy(dict(cfg))
        if 'type' not in cfg:
            raise KeyError(f'config for {self.name} has no "type": {cfg}')
        obj_type = cfg.pop('type')
        if isinstance(obj_type, str):
            ctor = self.get(obj_type)
            if ctor is None:
                raise KeyError(f'{obj_type} is not registered in {self.name}. '
                               f'Available: {sorted(self._module_dict)}')
        elif inspect.isclass(obj_type) or callable(obj_type):
            ctor = obj_type
        else:
            raise TypeError(f'type must be a str or callable, got '
                            f'{type(obj_type)}')
        for k, v in (default_args or {}).items():
            cfg.setdefault(k, v)
        return ctor(**cfg)


MODELS = Registry('models')            # top-level compositions
MODULES = Registry('modules')          # diffusion math, denoisers, losses
HOOKS = Registry('hooks')              # runner hooks
DATASETS = Registry('datasets')        # datasets
SCHEDULERS = Registry('schedulers')    # inference-time flow schedulers


def build_model(cfg, default_args=None):
    return MODELS.build(cfg, default_args)


def build_module(cfg, default_args=None):
    return MODULES.build(cfg, default_args)
