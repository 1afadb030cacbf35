"""Serving weight formats for the engines.

Counterpart of ``deepspeed_tpu/inference/quantization.py``
(``quantize_param_tree`` / ``dequantize_param_tree`` and
``w8a8_dot_general``), in its four formats, ``WEIGHT_FORMATS``:

- ``"int8"``: group-wise int8, an fp32 scale and offset a group (kernel
  #6 of ``ops/quantization.py`` once a weight when the engine is built,
  #7 at every use);
- ``"fp8"``: float8_e4m3fn with one fp32 scale a tensor (K1,
  ``dequant_scaled``, at every use);
- ``"fp6"``: e3m2 codes packed four to three bytes, an fp32 scale a group
  (K2, ``dequantize_fp6``, at every use);
- ``"w8a8"``: int8 with one fp32 scale an output channel for every
  ``nn.Linear`` weight, stored ``[out, in]`` (K-major rows, as the int8
  ``wgmma`` of the W8A8 GEMM reads them).  A model that consumes it
  natively (v2 on a module class with ``w8a8_native``, as the JAX v2
  engine) runs :class:`W8A8Linear`: activations quantize per row, the
  product is int8 x int8 with int32 sums, and the epilogue rescales, so
  the weight never expands.  Otherwise (v1, as the JAX v1 engine
  dequantizes its whole tree) the weight expands at use through K1, one
  scale a row.  Embeddings fall back to group-wise int8, as the
  reference's leaf filter sends every non-``kernel`` leaf.

Every expansion and the W8A8 Linear are hand-written kernels on the card
(``ops/csrc/quantization.cu``, ``ops/csrc/weight_formats.cu``,
``ops/csrc/w8a8_gemm.cu``); quantizing stays PyTorch operations, once a
weight.  The other formats' products stay cuBLAS, as the JAX package
leaves them to XLA outside any Pallas kernel.

:func:`quantize_model_` swaps each quantized ``nn.Linear`` for a
:class:`QuantizedLinear` (:class:`W8A8Linear` when native) and each
``nn.Embedding`` (GPT-2's ``Embed`` too) for a :class:`QuantizedEmbedding`
in place.  The leaf filter is the reference's: the flax matmul leaves
``kernel`` (an ``nn.Linear`` weight) and ``embedding`` (an
``nn.Embedding`` weight) with ``ndim >= 2`` and at least ``min_size``
elements; norm scales and biases stay in the serving dtype.  An
:class:`~deepspeed_tpu_torch.moe.MoE` layer's expert banks (``w1``,
``w3`` ``[E, M, I]`` and ``w2`` ``[E, I, M]``, the reference's leaves of
those names) become :class:`QuantizedBank` holders under the same rule,
w8a8 sending them to group-wise int8 as it sends embeddings; the router
``gate`` and the gelu banks' biases stay as they are.  (``wi``/``wo``,
the reference's other matmul leaf names, name no port module.)

Groups and the fp8 payload run over the FLAX layout, so the buffers equal
the JAX package's for the same weights: a Linear quantizes ``weight.t()``
(flax's ``[in, out]`` kernel) in row-major order, an Embedding its
``[vocab, hidden]`` table and a bank its ``[E, ...]`` stack as they are;
a w8a8 payload is the flax one transposed.  The port quantizes each
layer's weight on its own, where the JAX engines quantize a scan-stacked
tree's ``[L, in, out]`` (or ``[L, E, ...]``) leaf whole
(ROADMAP §C): int8 and fp6 agree whenever a layer's weight is a multiple
of the group size, as at every preset's widths; an fp8 weight takes its
own layer's scale where the stacked leaf has one for all layers (the
bridge carries that one to every layer exactly).

Buffers keep their dtypes (payload int8, uint8 or float8_e4m3fn, scales
fp32): the engines cast only parameters to the serving dtype, and nothing
after quantization may call ``nn.Module.to(dtype)``, which would cast the
fp8 payload and the scales too.
"""
from __future__ import annotations

import dataclasses

from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.ops.quantization import (FP6Tensor, FP8Tensor,
                                                  QuantizedTensor,
                                                  dequant_scaled, dequantize,
                                                  dequantize_fp6,
                                                  dequantize_fp8, quantize,
                                                  quantize_fp6, quantize_fp8,
                                                  quantize_per_channel,
                                                  w8a8_linear)

WEIGHT_FORMATS = ("int8", "fp8", "fp6", "w8a8")
# the buffers of each format, in the order of the JAX QuantizedWeight's
# arrays
FORMAT_BUFFERS = {"int8": ("values", "scale", "offset"),
                  "fp8": ("values", "scale"), "fp6": ("values", "scale"),
                  "w8a8": ("values", "scale")}


def check_format(fmt: str) -> None:
    """Raise ``ValueError`` for a weight format that is not one of
    ``WEIGHT_FORMATS``."""
    if fmt not in WEIGHT_FORMATS:
        raise ValueError(f"weight format {fmt!r}: expected one of "
                         f"{WEIGHT_FORMATS}")


class _Quantized(nn.Module):
    """One weight's buffers in format ``fmt`` (``FORMAT_BUFFERS``), with the
    weight's flax shape and dtype.  Buffers keep their dtypes: the engines
    cast only parameters to the serving dtype."""

    def __init__(self, fmt: str, buffers: Tuple[torch.Tensor, ...],
                 shape: Tuple[int, ...], dtype: torch.dtype):
        super().__init__()
        self.fmt = fmt
        for name, t in zip(FORMAT_BUFFERS[fmt], buffers, strict=True):
            self.register_buffer(name, t)
        self.shape = tuple(shape)
        self.dtype = dtype

    def dequantized(self) -> torch.Tensor:
        """The weight in its flax layout and original dtype: kernel #7
        (int8), K1 (fp8, and w8a8 one scale a row), or K2 (fp6) on the
        card."""
        if self.fmt == "int8":
            return dequantize(QuantizedTensor(self.values, self.scale,
                                              self.offset, self.shape,
                                              self.dtype))
        if self.fmt == "fp8":
            return dequantize_fp8(FP8Tensor(self.values, self.scale,
                                            self.shape, self.dtype))
        if self.fmt == "fp6":
            return dequantize_fp6(FP6Tensor(self.values, self.scale,
                                            self.shape, self.dtype,
                                            self.group_size))
        # w8a8 stored [out, in]: flax's [in, out] is its transpose
        return dequant_scaled(self.values, self.scale, self.dtype).t()

    @property
    def group_size(self) -> int:
        """Values a scale covers: int8's and fp6's group size, 0 for the
        per-tensor and per-channel formats."""
        if self.fmt == "int8":
            return self.values.shape[1]
        if self.fmt == "fp6":
            return self.values.shape[1] * 4 // 3
        return 0


class QuantizedLinear(_Quantized):
    """``nn.Linear`` over a quantized weight (flax's ``[in, out]`` kernel):
    ``x @ kernel + bias``, the kernel dequantized at every call."""

    def __init__(self, fmt: str, buffers: Tuple[torch.Tensor, ...],
                 shape: Tuple[int, ...], dtype: torch.dtype,
                 bias: Optional[torch.Tensor]):
        super().__init__(fmt, buffers, shape, dtype)
        self.bias = None if bias is None else nn.Parameter(bias,
                                                           requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.dequantized().t(), self.bias)


class W8A8Linear(QuantizedLinear):
    """``nn.Linear`` over a w8a8 weight consumed natively: the JAX
    ``w8a8_dot_general`` (rows quantized per row, an int8 product with
    int32 sums, the rescale into ``x``'s dtype: on the card the W8A8
    pre-pass and GEMM), then the bias, as flax's Dense adds it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = w8a8_linear(x, self.values, self.scale)
        return y if self.bias is None else y + self.bias


class QuantizedEmbedding(_Quantized):
    """``nn.Embedding`` over a quantized ``[vocab, hidden]`` table,
    dequantized at every call: a lookup, or with ``attend`` the tied head
    ``x @ table^T`` (GPT-2's ``Embed``), each call one dequant launch."""

    def forward(self, x: torch.Tensor, attend: bool = False) -> torch.Tensor:
        table = self.dequantized()
        return F.linear(x, table) if attend else F.embedding(x, table)


class QuantizedBank(_Quantized):
    """An MoE layer's expert bank (``[E, M, I]`` or ``[E, I, M]``, the
    layout the layer's ``torch.bmm`` reads) in int8, fp8 or fp6, in place
    of the layer's parameter of that name.  The layer expands the whole
    bank at every call with :meth:`dequantized`, one kernel launch, as the
    JAX engines expand every leaf once a dispatch."""


def _quantize_weight(w: torch.Tensor, fmt: str, group_size: int,
                     linear: bool
                     ) -> Tuple[Tuple[torch.Tensor, ...], Tuple[int, ...]]:
    """The buffers and flax shape of a module's weight ``w`` (a Linear's
    ``[out, in]``, or an Embedding's table) in ``fmt``."""
    if fmt == "w8a8":
        v, s = quantize_per_channel(w.contiguous())
        return (v, s), (w.shape[1], w.shape[0])
    w = w.t().contiguous() if linear else w.contiguous()     # flax layout
    if fmt == "int8":
        t = quantize(w, num_bits=8, group_size=group_size)
        return (t.values, t.scale, t.offset), t.shape
    if fmt == "fp8":
        t = quantize_fp8(w)
        return (t.values, t.scale), t.shape
    t = quantize_fp6(w, group_size=group_size)
    return (t.values, t.scale), t.shape


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@torch.no_grad()
def quantize_model_(module: nn.Module, fmt: str = "int8",
                    group_size: int = 2048, min_size: int = 1024,
                    native_w8a8: bool = False,
                    draw: Optional[Callable[[nn.Module], None]] = None
                    ) -> Tuple[int, int]:
    """Quantize every matmul weight of ``module`` to ``fmt`` in place (see
    the module docstring for which) and return ``(bytes_before,
    bytes_after)`` over all its parameters, as ``quantize_param_tree``
    counts its tree's leaves.  ``group_size`` is int8's and fp6's;
    ``native_w8a8`` makes w8a8 Linears :class:`W8A8Linear`.  Weights are
    quantized one at a time on their own device, each full-precision
    weight freed as its quantized copy lands.  ``draw``, when given, is
    called on every module in ``modules()`` order just before its own
    weights are read: a module still on the meta device is then
    materialised and drawn one module at a time, so the full-precision
    model never exists whole (``inference/common.py::normalize_params``).
    A weight already quantized stays as it is."""
    check_format(fmt)
    before = sum(_nbytes(p) for p in module.parameters())
    # banks and tables: the reference's w8a8 covers 2-D kernels only,
    # and sends the rest to group-wise int8
    tfmt = "int8" if fmt == "w8a8" else fmt
    # names, not modules: a list of the modules would keep every replaced
    # module, and its full-precision weight, alive until the end
    for name in [n for n, _ in module.named_modules()]:
        mod = module.get_submodule(name)
        if draw is not None:
            draw(mod)
        if isinstance(mod, MoE):
            for bank in mod.banks:
                w = getattr(mod, bank)
                if not _quantizable(w, min_size):
                    continue
                buffers, shape = _quantize_weight(w.detach(), tfmt,
                                                  group_size, False)
                delattr(mod, bank)   # a parameter until now
                setattr(mod, bank,
                        QuantizedBank(tfmt, buffers, shape, w.dtype))
                del w
            continue
        if not (isinstance(mod, (nn.Linear, nn.Embedding))
                and _quantizable(mod.weight, min_size)):
            continue
        w = mod.weight.detach()
        if isinstance(mod, nn.Linear):
            bias = None if mod.bias is None else mod.bias.detach()
            buffers, shape = _quantize_weight(w, fmt, group_size, True)
            cls = (W8A8Linear if fmt == "w8a8" and native_w8a8
                   else QuantizedLinear)
            new = cls(fmt, buffers, shape, w.dtype, bias)
        else:
            buffers, shape = _quantize_weight(w, tfmt, group_size, False)
            new = QuantizedEmbedding(tfmt, buffers, shape, w.dtype)
        parent_name, _, attr = name.rpartition(".")
        setattr(module.get_submodule(parent_name), attr, new)
        del mod, w      # the last references to the full-precision weight
    if fmt == "w8a8" and native_w8a8 and hasattr(
            getattr(module, "config", None), "weight_quant"):
        # the model's Linears now consume w8a8 natively (LlamaConfig)
        module.config = dataclasses.replace(module.config,
                                            weight_quant="w8a8")
    after = sum(_nbytes(p) for p in module.parameters())
    after += sum(_nbytes(b) for m in module.modules()
                 if isinstance(m, _Quantized) for b in m.buffers(recurse=False))
    return before, after


def _quantizable(w, min_size: int) -> bool:
    """Whether ``w`` is a full-precision matmul weight of at least
    ``min_size`` elements (the reference's leaf filter)."""
    return (isinstance(w, torch.Tensor) and w.dim() >= 2
            and w.numel() >= min_size)
