"""Weight bridge between the JAX package's flax params and this port's
``state_dict``, both ways, for the Llama and GPT-2 families.

Takes the param tree as nested dicts of numpy arrays (optionally under a
``{"params": ...}`` wrapper) in either layer layout:

- scan-stacked: ``model/layers/block/<leaf>`` (Llama) or
  ``transformer/h/block/<leaf>`` (GPT-2) with a leading ``L`` axis
  (``scan_layers=True``, the training default; the unstacking rule is the
  reference's ``inference/common.py::unroll_scan_params``);
- unrolled: ``model/layers_<i>/<leaf>`` or ``transformer/h_<i>/<leaf>``.

Renames: Dense ``kernel [in, out]`` -> Linear ``weight [out, in]``,
``Embed.embedding`` -> ``weight``, RMSNorm and LayerNorm ``scale`` ->
``weight``, ``bias`` -> ``bias``.  The trees of ``LlamaLMLoss`` carry one
more level, ``lm``, on both sides (``GPT2LMLoss``'s ``transformer`` level
is the model's own).  The family is the one whose module names cover the
tree's; a name of neither family raises, so a tree of another model is
refused rather than half-loaded.  :func:`state_dict_to_flax` is the way
back, into either layer layout.

A tree the JAX package quantized (``quantize_param_tree``, "int8") carries
across too: each ``QuantizedWeight`` leaf (payload, scale and offset as
numpy arrays; recognised by its ``fmt`` and ``arrays``, as the port
imports nothing of the JAX package) becomes the ``values``, ``scale`` and
``offset`` buffers of the port's quantized module
(``inference/quantization.py``), unchanged: both quantize over the flax
flattening, so a ``kernel``'s payload is not transposed.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Set

import numpy as np
import torch

_FAMILIES = {
    "llama": dict(
        layers="layers",
        owners={"embed_tokens": "embedding", "norm": "scale",
                "input_layernorm": "scale",
                "post_attention_layernorm": "scale", "q_proj": "kernel",
                "k_proj": "kernel", "v_proj": "kernel", "o_proj": "kernel",
                "gate_proj": "kernel", "up_proj": "kernel",
                "down_proj": "kernel", "lm_head": "kernel"},
        containers={"lm", "model", "self_attn", "mlp"}),
    "gpt2": dict(
        layers="h",
        owners={"wte": "embedding", "wpe": "embedding", "ln_1": "scale",
                "ln_2": "scale", "ln_f": "scale", "c_attn": "kernel",
                "c_proj": "kernel", "c_fc": "kernel", "lm_head": "kernel"},
        containers={"transformer", "attn", "mlp"}),
}
for _fam in _FAMILIES.values():
    _fam["modules"] = frozenset(
        {_fam["layers"], *_fam["owners"], *_fam["containers"]})
    _fam["unrolled"] = re.compile(_fam["layers"] + r"_(\d+)")
_LEAVES = {"kernel": "weight", "embedding": "weight", "scale": "weight",
           "bias": "bias"}


def _family(names: Set[str], where: str) -> Dict[str, Any]:
    """The family whose module names cover ``names``; a ``KeyError``
    naming what neither family maps otherwise."""
    misses = {}
    for fam in _FAMILIES.values():
        miss = {n for n in names if n not in fam["modules"]
                and not fam["unrolled"].fullmatch(n)}
        if not miss:
            return fam
        misses[len(miss)] = miss
    raise KeyError(f"unmapped {where} name(s) {sorted(misses[min(misses)])}")


def _module_names(node: Mapping[str, Any]) -> Set[str]:
    """The keys of ``node``'s subtrees, all levels, but the scan level
    ``block``."""
    out = set()
    for key, val in node.items():
        if isinstance(val, Mapping):
            if key != "block":
                out.add(key)
            out |= _module_names(val)
    return out


def _first_leaf(node: Mapping[str, Any]) -> np.ndarray:
    for val in node.values():
        return _first_leaf(val) if isinstance(val, Mapping) else val
    raise ValueError("empty scan-stacked subtree")


def _tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:         # e.g. a view of a JAX array
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: by its bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _quantized_leaf(path: List[str], q, layer: Optional[int]
                    ) -> Dict[str, torch.Tensor]:
    """The buffers of one int8 ``QuantizedWeight`` leaf; of layer
    ``layer`` when the leaf is a scan-stacked ``[L, ...]`` one quantized
    whole (its groups split by layer only when none spans two)."""
    if q.fmt != "int8":
        raise NotImplementedError(
            f"{'/'.join(path)}: weight format {q.fmt!r} is not ported yet: "
            "ROADMAP A9.6")
    arrays = [np.asarray(a) for a in q.arrays]
    if layer is not None:
        per_layer = int(np.prod(q.shape[1:]))
        gs = arrays[0].shape[1]
        if per_layer % gs:
            raise ValueError(
                f"{'/'.join(path)}: groups of {gs} span the layers of a "
                f"scan-stacked leaf of {tuple(q.shape)} (ROADMAP §C); "
                "quantize an unrolled tree")
        rows = per_layer // gs
        arrays = [a[layer * rows:(layer + 1) * rows] for a in arrays]
    prefix = ".".join(path[:-1])
    return {f"{prefix}.{name}": _tensor(a)
            for name, a in zip(("values", "scale", "offset"), arrays)}


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax Llama or GPT-2 param tree,
    quantized leaves included."""
    if set(params) == {"params"}:
        params = params["params"]
    fam = _family(_module_names(params), "flax")
    out: Dict[str, torch.Tensor] = {}

    def leaf(path: List[str], arr, layer: Optional[int]) -> None:
        if hasattr(arr, "fmt") and hasattr(arr, "arrays"):
            out.update(_quantized_leaf(path, arr, layer))
            return
        arr = np.asarray(arr)
        if layer is not None:
            arr = arr[layer]
        if path[-1] == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: kernel of shape "
                                 f"{arr.shape}, want [in, out]")
            arr = arr.T
        out[".".join(path[:-1] + [_LEAVES[path[-1]]])] = _tensor(arr)

    def walk(node: Mapping[str, Any], path: List[str],
             layer: Optional[int]) -> None:
        for key, val in node.items():
            m = fam["unrolled"].fullmatch(key)
            if m:
                walk(val, path + [fam["layers"], m.group(1)], layer)
            elif key in _LEAVES and not isinstance(val, Mapping):
                leaf(path + [key], val, layer)
            elif key not in fam["modules"] or not isinstance(val, Mapping):
                raise KeyError(f"unmapped flax name {'/'.join(path + [key])}")
            elif set(val) == {"block"}:
                # scan-stacked layers: leading L axis on every leaf
                for i in range(_first_leaf(val["block"]).shape[0]):
                    walk(val["block"], path + [key, str(i)], i)
            else:
                walk(val, path + [key], layer)

    walk(params, [], None)
    return out


def state_dict_to_flax(state: Mapping[str, torch.Tensor],
                       scan_layers: bool = True) -> Dict[str, Any]:
    """The flax param tree (nested dicts of fp32 numpy arrays, without the
    ``{"params": ...}`` wrapper) of a port ``state_dict``: scan-stacked
    under ``layers/block`` (``h/block``) with a leading L axis, or
    unrolled as ``layers_<i>`` (``h_<i>``).  Linear weights ``[out, in]``
    become kernels ``[in, out]``."""
    fam = _family({p for name in state for p in name.split(".")[:-1]
                   if not p.isdigit()}, "port")
    layers = fam["layers"]
    tree: Dict[str, Any] = {}
    stacked: Dict[tuple, Dict[int, np.ndarray]] = {}
    for name, t in state.items():
        parts = name.split(".")
        arr = t.detach().float().cpu().numpy()
        owner = parts[-2]
        if parts[-1] == "weight" and owner in fam["owners"]:
            leaf = fam["owners"][owner]
            if leaf == "kernel":
                arr = arr.T
        elif parts[-1] == "bias" and owner in fam["owners"]:
            leaf = "bias"
        else:
            raise KeyError(f"unmapped port name {name}")
        path = parts[:-1] + [leaf]
        if layers in path:
            i = path.index(layers)
            layer = int(path[i + 1])
            if scan_layers:
                key = tuple(path[:i + 1] + ["block"] + path[i + 2:])
                stacked.setdefault(key, {})[layer] = arr
                continue
            path = path[:i] + [f"{layers}_{layer}"] + path[i + 2:]
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    for key, stack in stacked.items():
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = np.stack([stack[i] for i in range(len(stack))])
    return tree
