"""Weight bridge between the JAX package's flax params and this port's
``state_dict``, both ways, for the Llama, GPT-2, Mixtral and Qwen2-MoE
families.

Takes the param tree as nested dicts of numpy arrays (optionally under a
``{"params": ...}`` wrapper) in either layer layout:

- scan-stacked: ``model/layers/block/<leaf>`` (Llama) or
  ``transformer/h/block/<leaf>`` (GPT-2) with a leading ``L`` axis
  (``scan_layers=True``, the training default; the unstacking rule is the
  reference's ``inference/common.py::unroll_scan_params``);
- unrolled: ``model/layers_<i>/<leaf>`` or ``transformer/h_<i>/<leaf>``.

Renames: Dense ``kernel [in, out]`` -> Linear ``weight [out, in]``,
``Embed.embedding`` -> ``weight``, RMSNorm and LayerNorm ``scale`` ->
``weight``, ``bias`` -> ``bias``.  An MoE layer's raw params (``gate``,
``w1``, ``w2``, ``w3``; ``b1``, ``b2``), under ``block_sparse_moe``
(Mixtral) or ``mlp`` (Qwen2-MoE), keep their names and layout; flax's
partitioning boxes around the expert banks are opened.  The trees of
``LlamaLMLoss`` carry one
more level, ``lm``, on both sides (``GPT2LMLoss``'s ``transformer`` level
is the model's own).  The family is the one whose module and leaf names
cover the tree's (the raw params tell Qwen2-MoE's ``mlp`` from Llama's);
a name of no family raises, so a tree of another model is refused rather
than half-loaded.  :func:`state_dict_to_flax` is the way
back, into either layer layout.

A tree the JAX package quantized (``quantize_param_tree``, any of its
formats) carries across too: each ``QuantizedWeight`` leaf (its arrays as
numpy arrays; recognised by its ``fmt`` and ``arrays``, as the port
imports nothing of the JAX package) becomes the buffers of the port's
quantized module (``inference/quantization.py``): int8's ``values``,
``scale`` and ``offset``, fp8's, fp6's and w8a8's ``values`` and
``scale``.  Both quantize over the flax layout, so int8, fp8 and fp6
payloads are not transposed; a w8a8 payload is, into the ``[out, in]``
the port's int8 product reads.  An expert bank (``w1``, ``w2``, ``w3``)
becomes a quantized bank's buffers under the bank's own name
(``...block_sparse_moe.w1.values``).  A scan-stacked leaf quantized whole
(``[L, in, out]``, or ``[L, E, ...]`` for a bank) gives each layer its
slice: int8 and fp6 by groups (refused when a group spans two layers),
fp8 its payload slice and the one scale of the whole leaf; w8a8 leaves
are 2-D only.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Set

import numpy as np
import torch

from deepspeed_tpu_torch.inference.quantization import FORMAT_BUFFERS

_LLAMA_ATTN = {"embed_tokens": "embedding", "norm": "scale",
               "input_layernorm": "scale",
               "post_attention_layernorm": "scale", "q_proj": "kernel",
               "k_proj": "kernel", "v_proj": "kernel", "o_proj": "kernel",
               "lm_head": "kernel"}
_LLAMA_MLP = {"gate_proj": "kernel", "up_proj": "kernel",
              "down_proj": "kernel"}
# an MoE layer's raw params (router, expert banks, the gelu banks'
# biases): same name and layout on both sides, never transposed
_MOE_RAW = frozenset({"gate", "w1", "w2", "w3", "b1", "b2"})
_FAMILIES = {
    "llama": dict(
        layers="layers", owners={**_LLAMA_ATTN, **_LLAMA_MLP},
        containers={"lm", "model", "self_attn", "mlp"}),
    "gpt2": dict(
        layers="h",
        owners={"wte": "embedding", "wpe": "embedding", "ln_1": "scale",
                "ln_2": "scale", "ln_f": "scale", "c_attn": "kernel",
                "c_proj": "kernel", "c_fc": "kernel", "lm_head": "kernel"},
        containers={"transformer", "attn", "mlp"}),
    "mixtral": dict(
        layers="layers", owners=dict(_LLAMA_ATTN),
        containers={"lm", "model", "self_attn"},
        moe={"block_sparse_moe"}),
    # the routed experts sit under `mlp`, where Llama's dense MLP does;
    # the shared expert is a Llama MLP
    "qwen2_moe": dict(
        layers="layers",
        owners={**_LLAMA_ATTN, **_LLAMA_MLP, "shared_expert_gate": "kernel"},
        containers={"lm", "model", "self_attn", "shared_expert"},
        moe={"mlp"}),
}
_LEAVES = {"kernel": "weight", "embedding": "weight", "scale": "weight",
           "bias": "bias"}
for _fam in _FAMILIES.values():
    _fam.setdefault("moe", set())
    # names a tree of the family may hold, its leaves' included: the MoE
    # raw params tell an MoE `mlp` from Llama's
    _fam["modules"] = frozenset(
        {_fam["layers"], *_fam["owners"], *_fam["containers"],
         *_fam["moe"], *_LEAVES, "weight",
         *(_MOE_RAW if _fam["moe"] else ())})
    _fam["unrolled"] = re.compile(_fam["layers"] + r"_(\d+)")


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
    """The keys of ``node``, all levels, but the scan level ``block``."""
    out = set()
    for key, val in node.items():
        if key != "block":
            out.add(key)
        if isinstance(val, Mapping):
            out |= _module_names(val)
    return out


def _first_leaf(node: Mapping[str, Any]) -> np.ndarray:
    for val in node.values():
        return (_first_leaf(val) if isinstance(val, Mapping)
                else _unbox(val))
    raise ValueError("empty scan-stacked subtree")


def _unbox(val):
    """The array inside a flax partitioning box (``nn.Partitioned``,
    recognised by its ``value`` and ``names``: the MoE banks' expert axis),
    else ``val``."""
    if hasattr(val, "value") and hasattr(val, "names"):
        return val.value
    return val


def _tensor(arr: np.ndarray) -> torch.Tensor:
    # (ascontiguousarray makes a 0-d array, fp8's scale, 1-d)
    arr = np.ascontiguousarray(arr).reshape(np.shape(arr))
    if not arr.flags.writeable:         # e.g. a view of a JAX array
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":    # ml_dtypes' bfloat16: by its bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    if arr.dtype.name == "float8_e4m3fn":   # ml_dtypes' too
        return torch.from_numpy(arr.view(np.uint8)).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(arr)


def _is_quantized(val) -> bool:
    """Whether ``val`` is a JAX ``QuantizedWeight`` (by its ``fmt`` and
    ``arrays``)."""
    return hasattr(val, "fmt") and hasattr(val, "arrays")


def _quantized_leaf(path: List[str], q, layer: Optional[int]
                    ) -> Dict[str, torch.Tensor]:
    """The buffers of one ``QuantizedWeight`` leaf; of layer ``layer``
    when the leaf is a scan-stacked ``[L, ...]`` one quantized whole."""
    where = "/".join(path)
    names = FORMAT_BUFFERS.get(q.fmt)
    if names is None:
        raise ValueError(f"{where}: unknown weight format {q.fmt!r}")
    arrays = [np.asarray(a) for a in q.arrays]
    if q.fmt == "w8a8":
        if layer is not None or arrays[0].ndim != 2:
            raise ValueError(f"{where}: a w8a8 leaf is a 2-D kernel, got "
                             f"{tuple(q.shape)} (the JAX engines unroll "
                             "before quantizing to w8a8)")
        arrays[0] = arrays[0].T
    elif layer is not None and q.fmt == "fp8":
        # one scale for the whole stacked leaf: each layer's slice with it
        arrays[0] = arrays[0][layer]
    elif layer is not None:
        per_layer = int(np.prod(q.shape[1:]))
        gs = q.group_size if q.fmt == "fp6" else arrays[0].shape[1]
        if per_layer % gs:
            raise ValueError(
                f"{where}: groups of {gs} span the layers of a "
                f"scan-stacked leaf of {tuple(q.shape)} (ROADMAP §C); "
                "quantize an unrolled tree")
        rows = per_layer // gs
        arrays = [a[layer * rows:(layer + 1) * rows] for a in arrays]
    # a kernel or table names its module's weight; a bank is the module
    owner = ".".join(path[:-1] if path[-1] in _LEAVES else path)
    return {f"{owner}.{name}": _tensor(a)
            for name, a in zip(names, arrays)}


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax Llama or GPT-2 param tree,
    quantized leaves included."""
    if set(params) == {"params"}:
        params = params["params"]
    fam = _family(_module_names(params), "flax")
    out: Dict[str, torch.Tensor] = {}

    def leaf(path: List[str], arr, layer: Optional[int]) -> None:
        if _is_quantized(arr):
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
            val = _unbox(val)
            m = fam["unrolled"].fullmatch(key)
            if m:
                walk(val, path + [fam["layers"], m.group(1)], layer)
            elif key in _LEAVES and not isinstance(val, Mapping):
                leaf(path + [key], val, layer)
            elif (key in _MOE_RAW and path and path[-1] in fam["moe"]
                  and _is_quantized(val)):
                out.update(_quantized_leaf(path + [key], val, layer))
            elif (key in _MOE_RAW and path and path[-1] in fam["moe"]
                  and not isinstance(val, Mapping)):
                arr = np.asarray(val)
                out[".".join(path + [key])] = _tensor(
                    arr if layer is None else arr[layer])
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
    fam = _family({p for name in state for p in name.split(".")
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
        elif parts[-1] in _MOE_RAW and owner in fam["moe"]:
            leaf = parts[-1]
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
