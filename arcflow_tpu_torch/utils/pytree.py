"""Parameter-name matching and merging.

The port's own copy of what it needs from ``arcflow_tpu/utils/pytree.py``:
the JAX package splits a parameter tree into (trainable, frozen) by path
substring and overlays the adapter onto the shared base; here the same
matching runs on dotted parameter names (``joint_blocks.3.ff_img.in_proj.
lora_a``), which contain the JAX path's segments, so a key matches the same
leaves on both sides.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence


def flatten(tree: Mapping, prefix: str = '') -> Dict[str, Any]:
    """Nested dict -> {'a.b.c': leaf}."""
    out = {}
    for k, v in tree.items():
        key = f'{prefix}{k}'
        if isinstance(v, Mapping):
            out.update(flatten(v, key + '.'))
        else:
            out[key] = v
    return out


def name_matches(name: str, keys: Sequence[str],
                 exact_prefix: bool = False) -> bool:
    """Whether dotted ``name`` contains one of ``keys`` (the reference's
    freeze_exclude rule), or with ``exact_prefix`` starts with one as whole
    leading segments (so 'proj_out' takes the top-level head and not
    'single_blocks.0.proj_out')."""
    if exact_prefix:
        return any(name == k or name.startswith(k + '.') for k in keys)
    return any(k in name for k in keys)


def merge_params(*trees: Mapping) -> Dict[str, Any]:
    """Flat overlay-merge of nested or flat dicts; later ones win."""
    out: Dict[str, Any] = {}
    for t in trees:
        if t:
            out.update(flatten(t))
    return out
