"""Weight-only quantization for the serving engines.

Counterpart of ``deepspeed_tpu/inference/quantization.py`` for the int8
format (``quantize_param_tree`` / ``dequantize_param_tree``): every
matmul weight of at least ``min_size`` elements is stored as an int8
payload with one fp32 scale and offset per group (kernel #6 of
``ops/quantization.py``, once per weight when the engine is built), and is
dequantized at use, one weight at a time, by kernel #7 before its product.
The product itself stays ``F.linear`` (cuBLAS), as the JAX package leaves
it to XLA outside any Pallas kernel.

:func:`quantize_model_` swaps each quantized ``nn.Linear`` for a
:class:`QuantizedLinear` and each ``nn.Embedding`` (GPT-2's ``Embed``
too) for a :class:`QuantizedEmbedding` in place.  The leaf filter is the
reference's: the flax matmul leaves ``kernel`` (an ``nn.Linear`` weight)
and ``embedding`` (an ``nn.Embedding`` weight) with ``ndim >= 2`` and at
least ``min_size`` elements; norm scales and biases stay in the serving
dtype.  (The reference's other matmul leaf names, ``w1``/``w2``/``w3``/
``wi``/``wo``, belong to MoE expert stacks, which the port has not yet.)

Groups run over the FLAX flattening, so the payload, scales and offsets
equal the JAX package's for the same weights: a Linear quantizes
``weight.t()`` (flax's ``[in, out]`` kernel) in row-major order, an
Embedding its ``[vocab, hidden]`` table as is.  The port quantizes each
layer's weight on its own, where the JAX v1 engine quantizes a
scan-stacked tree's ``[L, in, out]`` leaf whole (ROADMAP §C): the two
agree whenever a layer's weight is a multiple of the group size, as at
every preset's widths.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from deepspeed_tpu_torch.ops.quantization import (QuantizedTensor,
                                                  dequantize, quantize)

WEIGHT_FORMATS = ("int8", "fp8", "fp6", "w8a8")
_UNPORTED_FORMATS = ("fp8", "fp6", "w8a8")


def check_format(fmt: str) -> None:
    """Raise for a weight format the port cannot serve: ``ValueError`` for
    an unknown one, ``NotImplementedError`` naming ROADMAP A9.6 for the
    reference's fp8, fp6 and w8a8."""
    if fmt not in WEIGHT_FORMATS:
        raise ValueError(f"weight format {fmt!r}: expected one of "
                         f"{WEIGHT_FORMATS}")
    if fmt in _UNPORTED_FORMATS:
        raise NotImplementedError(
            f"weight format {fmt!r} is not ported yet: ROADMAP A9.6 (only "
            "int8 weight-only serving is)")


class _Quantized(nn.Module):
    """The payload (int8 ``[groups, gs]``), scale and offset (fp32
    ``[groups, 1]``) of one weight as buffers, with the weight's flax
    shape and dtype.  Buffers keep their dtypes: the engines cast only
    parameters to the serving dtype."""

    def __init__(self, qt: QuantizedTensor):
        super().__init__()
        self.register_buffer("values", qt.values)
        self.register_buffer("scale", qt.scale)
        self.register_buffer("offset", qt.offset)
        self.shape = tuple(qt.shape)
        self.dtype = qt.dtype

    def dequantized(self) -> torch.Tensor:
        """The weight in its flax shape and original dtype (kernel #7 on
        the card)."""
        return dequantize(QuantizedTensor(self.values, self.scale,
                                          self.offset, self.shape,
                                          self.dtype))

    @property
    def group_size(self) -> int:
        return self.values.shape[1]


class QuantizedLinear(_Quantized):
    """``nn.Linear`` over an int8 weight stored as flax's ``[in, out]``
    kernel: ``x @ kernel + bias``, the kernel dequantized at every call."""

    def __init__(self, qt: QuantizedTensor, bias: Optional[torch.Tensor]):
        super().__init__(qt)
        self.bias = None if bias is None else nn.Parameter(bias,
                                                           requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.dequantized().t(), self.bias)


class QuantizedEmbedding(_Quantized):
    """``nn.Embedding`` over an int8 ``[vocab, hidden]`` table, dequantized
    at every call: a lookup, or with ``attend`` the tied head ``x @
    table^T`` (GPT-2's ``Embed``), each call one dequantize launch."""

    def forward(self, x: torch.Tensor, attend: bool = False) -> torch.Tensor:
        table = self.dequantized()
        return F.linear(x, table) if attend else F.embedding(x, table)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@torch.no_grad()
def quantize_model_(module: nn.Module, fmt: str = "int8",
                    group_size: int = 2048,
                    min_size: int = 1024) -> Tuple[int, int]:
    """Quantize every matmul weight of ``module`` to ``fmt`` in place (see
    the module docstring for which) and return ``(bytes_before,
    bytes_after)`` over all its parameters, as ``quantize_param_tree``
    counts its tree's leaves.  Weights are quantized one at a time on
    their own device, each full-precision weight freed as its int8 copy
    lands."""
    check_format(fmt)
    before = sum(_nbytes(p) for p in module.parameters())
    names = [name for name, mod in module.named_modules()
             if isinstance(mod, (nn.Linear, nn.Embedding))
             and mod.weight.dim() >= 2 and mod.weight.numel() >= min_size]
    for name in names:
        mod = module.get_submodule(name)
        w = mod.weight.detach()
        if isinstance(mod, nn.Linear):
            bias = None if mod.bias is None else mod.bias.detach()
            new = QuantizedLinear(
                quantize(w.t().contiguous(), group_size=group_size), bias)
        else:
            new = QuantizedEmbedding(quantize(w.contiguous(),
                                              group_size=group_size))
        parent_name, _, attr = name.rpartition(".")
        setattr(module.get_submodule(parent_name), attr, new)
        del mod, w      # the last references to the full-precision weight
    after = sum(_nbytes(p) for p in module.parameters())
    after += sum(_nbytes(b) for m in module.modules()
                 if isinstance(m, _Quantized) for b in m.buffers(recurse=False))
    return before, after
