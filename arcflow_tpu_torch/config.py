"""Python-file experiment configs with ``_base_`` inheritance.

The port's own copy of ``arcflow_tpu/config.py`` (the port imports nothing
of the JAX package): ``ConfigDict``, ``Config.fromfile`` with ``_base_``
lists and ``_delete_``, ``merge_from_dict`` for ``--cfg-options`` dot keys
with ``_parse_value``, and ``dump``. A config file loads to the same dict
here as there. The config *is* the experiment: model graph, optimizer,
data, hooks and resume policy are plain nested dicts.
"""

from __future__ import annotations

import ast
import copy
import os
import os.path as osp
import types
from typing import Any, Dict, Optional

DELETE_KEY = '_delete_'
BASE_KEY = '_base_'
RESERVED_KEYS = ('filename', 'text')


class ConfigDict(dict):
    """Dict with attribute access, used for all config nodes."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __deepcopy__(self, memo):
        out = ConfigDict()
        memo[id(self)] = out
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out


def _to_config_dict(obj):
    if isinstance(obj, dict):
        return ConfigDict({k: _to_config_dict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_config_dict(v) for v in obj)
    return obj


def _merge_a_into_b(a: dict, b: dict) -> dict:
    """Merge override dict ``a`` into base dict ``b`` (recursively)."""
    b = copy.deepcopy(b)
    for k, v in a.items():
        if isinstance(v, dict) and k in b and not v.pop(DELETE_KEY, False):
            if not isinstance(b[k], dict):
                raise TypeError(
                    f'cannot merge dict into non-dict for key "{k}" '
                    f'({type(b[k])}); add _delete_=True to override')
            b[k] = _merge_a_into_b(v, b[k])
        else:
            if isinstance(v, dict):
                v = {kk: vv for kk, vv in v.items() if kk != DELETE_KEY}
            b[k] = copy.deepcopy(v)
    return b


def _exec_pyfile(filename: str) -> Dict[str, Any]:
    filename = osp.abspath(osp.expanduser(filename))
    if not osp.isfile(filename):
        raise FileNotFoundError(filename)
    with open(filename, encoding='utf-8') as f:
        source = f.read()
    # validate syntax early for a clear error message
    ast.parse(source, filename=filename)
    mod = types.ModuleType('_cfg_')
    mod.__file__ = filename
    exec(compile(source, filename, 'exec'), mod.__dict__)
    cfg = {k: v for k, v in mod.__dict__.items()
           if not k.startswith('__') and not isinstance(v, types.ModuleType)
           and not callable(v) or isinstance(v, type)}
    # keep callables out unless explicitly stored in dicts
    cfg = {k: v for k, v in cfg.items()
           if not (callable(v) and not isinstance(v, type))}
    return cfg, source


class Config:
    """Loaded experiment config.

    Usage::

        cfg = Config.fromfile('configs/toy/checkerboard.py')
        cfg.model.diffusion.nfe
        cfg.merge_from_dict({'model.diffusion.nfe': 4})
    """

    def __init__(self, cfg_dict: Optional[dict] = None, filename: Optional[str] = None,
                 text: str = ''):
        cfg_dict = cfg_dict or {}
        for k in RESERVED_KEYS:
            if k in cfg_dict:
                raise KeyError(f'{k} is a reserved key')
        object.__setattr__(self, '_cfg_dict', _to_config_dict(cfg_dict))
        object.__setattr__(self, '_filename', filename)
        object.__setattr__(self, '_text', text)

    # ---- loading -------------------------------------------------------
    @staticmethod
    def fromfile(filename: str) -> 'Config':
        cfg_dict, text = Config._load_with_bases(filename)
        return Config(cfg_dict, filename=filename, text=text)

    @staticmethod
    def _load_with_bases(filename: str):
        cfg_dict, text = _exec_pyfile(filename)
        base_files = cfg_dict.pop(BASE_KEY, None)
        if base_files is None:
            return cfg_dict, text
        if isinstance(base_files, str):
            base_files = [base_files]
        base_dict: Dict[str, Any] = {}
        cfg_dir = osp.dirname(osp.abspath(osp.expanduser(filename)))
        texts = []
        for base in base_files:
            b_dict, b_text = Config._load_with_bases(osp.join(cfg_dir, base))
            dup = set(base_dict) & set(b_dict)
            if dup:
                raise KeyError(f'duplicate keys across _base_ files: {dup}')
            base_dict.update(b_dict)
            texts.append(b_text)
        merged = _merge_a_into_b(cfg_dict, base_dict)
        texts.append(text)
        return merged, '\n'.join(texts)

    # ---- access --------------------------------------------------------
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
        self._cfg_dict[name] = _to_config_dict(value)

    def __setitem__(self, name, value):
        self._cfg_dict[name] = _to_config_dict(value)

    def __contains__(self, name):
        return name in self._cfg_dict

    def __iter__(self):
        return iter(self._cfg_dict)

    def get(self, key, default=None):
        return self._cfg_dict.get(key, default)

    def keys(self):
        return self._cfg_dict.keys()

    def items(self):
        return self._cfg_dict.items()

    def to_dict(self) -> dict:
        def _plain(obj):
            if isinstance(obj, dict):
                return {k: _plain(v) for k, v in obj.items()}
            if isinstance(obj, (list, tuple)):
                return type(obj)(_plain(v) for v in obj)
            return obj
        return _plain(self._cfg_dict)

    def copy(self) -> 'Config':
        return Config(copy.deepcopy(self._cfg_dict), filename=self._filename,
                      text=self._text)

    # ---- CLI merging (--cfg-options a.b.c=v) ----------------------------
    def merge_from_dict(self, options: Dict[str, Any]):
        """Merge dot-keyed overrides, parsing literal values from strings."""
        option_cfg: Dict[str, Any] = {}
        for full_key, v in options.items():
            d = option_cfg
            keys = full_key.split('.')
            for k in keys[:-1]:
                d = d.setdefault(k, {})
            d[keys[-1]] = _parse_value(v)
        merged = _merge_a_into_b(option_cfg, dict(self._cfg_dict))
        object.__setattr__(self, '_cfg_dict', _to_config_dict(merged))

    def dump(self, path: str):
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        with open(path, 'w', encoding='utf-8') as f:
            f.write(self.pretty_text)

    @property
    def pretty_text(self) -> str:
        import pprint
        return pprint.pformat(self.to_dict(), width=100, sort_dicts=False)


def _parse_value(v: Any) -> Any:
    """Parse a CLI string into a python literal when possible."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        lowered = v.lower()
        if lowered in ('true', 'false'):
            return lowered == 'true'
        if lowered in ('none', 'null'):
            return None
        return v
