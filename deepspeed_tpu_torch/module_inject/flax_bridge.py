"""Weight bridge: the JAX package's flax Llama params -> this port's
``state_dict``.

Takes the param tree as nested dicts of numpy arrays (optionally under a
``{"params": ...}`` wrapper) in either layer layout:

- scan-stacked: ``model/layers/block/<leaf>`` with a leading ``L`` axis
  (``scan_layers=True``, the training default; the unstacking rule is the
  reference's ``inference/common.py::unroll_scan_params``);
- unrolled: ``model/layers_<i>/<leaf>``.

Renames: Dense ``kernel [in, out]`` -> Linear ``weight [out, in]``,
``Embed.embedding`` -> ``weight``, RMSNorm ``scale`` -> ``weight``,
``bias`` -> ``bias``.  Any module or leaf name outside the Llama family's
raises, so a tree of another model is refused rather than half-loaded.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

_MODULES = frozenset({
    "model", "embed_tokens", "layers", "norm", "lm_head",
    "input_layernorm", "post_attention_layernorm", "self_attn", "mlp",
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
    "down_proj"})
_LEAVES = {"kernel": "weight", "embedding": "weight", "scale": "weight",
           "bias": "bias"}
_UNROLLED = re.compile(r"layers_(\d+)")


def _first_leaf(node: Mapping[str, Any]) -> np.ndarray:
    for val in node.values():
        return _first_leaf(val) if isinstance(val, Mapping) else val
    raise ValueError("empty scan-stacked subtree")


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax Llama param tree."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def leaf(path: List[str], arr, layer: Optional[int]) -> None:
        arr = np.asarray(arr)
        if layer is not None:
            arr = arr[layer]
        if path[-1] == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: kernel of shape "
                                 f"{arr.shape}, want [in, out]")
            arr = arr.T
        arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:     # e.g. a view of a JAX array
            arr = arr.copy()
        out[".".join(path[:-1] + [_LEAVES[path[-1]]])] = torch.from_numpy(arr)

    def walk(node: Mapping[str, Any], path: List[str],
             layer: Optional[int]) -> None:
        for key, val in node.items():
            m = _UNROLLED.fullmatch(key)
            if m:
                walk(val, path + ["layers", m.group(1)], layer)
            elif key in _LEAVES and not isinstance(val, Mapping):
                leaf(path + [key], val, layer)
            elif key not in _MODULES or not isinstance(val, Mapping):
                raise KeyError(f"unmapped flax name {'/'.join(path + [key])}")
            elif set(val) == {"block"}:
                # scan-stacked layers: leading L axis on every leaf
                for i in range(_first_leaf(val["block"]).shape[0]):
                    walk(val["block"], path + [key, str(i)], i)
            else:
                walk(val, path + [key], layer)

    walk(params, [], None)
    return out
