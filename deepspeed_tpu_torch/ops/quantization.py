"""Group-wise int8 quantization for the H100.

Counterpart of the int8 part of ``deepspeed_tpu/ops/quantization.py``:
values are viewed as ``[num_groups, group_size]`` over the row-major
flattening (the tail zero-padded), and each group gets an fp32 scale, and
an offset when asymmetric:

- symmetric: ``scale = max(absmax, 1e-12) / q_max``, offset 0;
- asymmetric: ``scale = max(mx - mn, 1e-12) / (2 q_max)``,
  ``offset = (mx + mn) * 0.5``;
- payload ``clip(round((x - offset) / scale), -q_max, q_max)`` as int8,
  with ``q_max`` 127 (8 bits) or 7 (4 bits, stored unpacked in int8);
- dequant ``v * scale + offset`` in fp32, cast to the original dtype,
  the first ``n`` elements kept.

The TPU kernels ``_quant_kernel`` and ``_dequant_kernel`` become the
hand-written CUDA kernels of ``csrc/quantization.cu`` (see the note at its
top).  Beside them, the plain PyTorch versions :func:`quantize_reference`
and :func:`dequantize_reference`, bit-identical to the JAX package's jnp
branch and to the kernels.  CPU tensors take the plain versions; CUDA
tensors launch the kernel or raise.  ``quantize.launches`` and
``dequantize.launches`` count launches.  The fp8 and fp6 formats of the
JAX module are plain array code there, not Pallas kernels; they come with
ROADMAP A9.6.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
from torch.nn import functional as F

from deepspeed_tpu_torch.ops import builder

_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_EPS = 1e-12


class QuantizedTensor(NamedTuple):
    """int8 payload + per-group scale/offset + original shape/dtype."""
    values: torch.Tensor     # int8 [num_groups, group_size]
    scale: torch.Tensor      # fp32 [num_groups, 1]
    offset: torch.Tensor     # fp32 [num_groups, 1] (zeros when symmetric)
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _q_max(num_bits: int) -> float:
    if num_bits not in (4, 8):
        raise ValueError(f"num_bits must be 4 or 8, got {num_bits}")
    return float(2 ** (num_bits - 1) - 1)


def _num_groups(n: int, group_size: int) -> int:
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    return max(-(-n // group_size), 0)


def quantize_reference(x: torch.Tensor, num_bits: int = 8,
                       group_size: int = 2048,
                       symmetric: bool = True) -> QuantizedTensor:
    """:func:`quantize` in plain PyTorch: the jnp branch of the JAX
    ``quantize``, operation for operation."""
    q_max = _q_max(num_bits)
    n = x.numel()
    num_groups = _num_groups(n, group_size)
    xg = F.pad(x.reshape(-1).float(), (0, num_groups * group_size - n))
    xg = xg.view(num_groups, group_size)
    # divisors as device tensors: on CUDA, PyTorch divides by a Python
    # scalar as a multiply by its reciprocal, an ulp off the IEEE quotient
    # the JAX package and the kernel take
    div = torch.tensor([q_max, 2.0 * q_max], device=x.device)
    if symmetric:
        absmax = xg.abs().amax(dim=1, keepdim=True)
        s = absmax.clamp_min(_EPS) / div[0]
        o = torch.zeros_like(s)
    else:
        mx = xg.amax(dim=1, keepdim=True)
        mn = xg.amin(dim=1, keepdim=True)
        s = (mx - mn).clamp_min(_EPS) / div[1]
        o = (mx + mn) * 0.5
    v = torch.clamp(torch.round((xg - o) / s), -q_max, q_max).to(torch.int8)
    return QuantizedTensor(v, s, o, tuple(x.shape), x.dtype)


def dequantize_reference(qt: QuantizedTensor,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`dequantize` in plain PyTorch (the jnp branch of the JAX
    ``dequantize``)."""
    x = qt.values.float() * qt.scale + qt.offset
    n = _numel(qt.shape)
    x = x.reshape(-1)[:n].reshape(qt.shape).to(qt.dtype)
    if out is None:
        return x
    return out.copy_(x)


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _lib() -> ctypes.CDLL:
    lib = builder.load("quantization")
    if lib.dstpu_quantize.argtypes is None:
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        lib.dstpu_quantize.argtypes = [ptr, i32, ptr, ptr, ptr, i64, i64,
                                       i32, f32, f32, f32, i32, ptr]
        lib.dstpu_quantize.restype = i32
        lib.dstpu_dequantize.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32,
                                         ptr]
        lib.dstpu_dequantize.restype = i32
        lib.dstpu_cuda_error_string.argtypes = [i32]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _device_call(fn_name: str, device: torch.device, *args) -> None:
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: " +
                           lib.dstpu_cuda_error_string(err).decode())


def _on_card(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def quantize(x: torch.Tensor, num_bits: int = 8, group_size: int = 2048,
             symmetric: bool = True) -> QuantizedTensor:
    """Group-wise int8 quantization of ``x`` (bf16, fp16 or fp32,
    contiguous) with ``num_bits`` 8 or 4 (the int4 range, unpacked in an
    int8 payload).  CPU tensors take :func:`quantize_reference`; CUDA
    tensors launch the kernel once."""
    q_max = _q_max(num_bits)
    if x.dtype not in _DTYPES:
        raise TypeError(f"quantize takes bfloat16, float16 or float32, got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("quantize reads a contiguous tensor (groups run "
                         "over the row-major flattening)")
    if x.device.type == "cpu":
        return quantize_reference(x, num_bits, group_size, symmetric)
    _on_card(x, "quantize")
    n = x.numel()
    num_groups = _num_groups(n, group_size)
    v = torch.empty(num_groups, group_size, dtype=torch.int8, device=x.device)
    s = torch.empty(num_groups, 1, dtype=torch.float32, device=x.device)
    o = torch.empty_like(s)
    _device_call("dstpu_quantize", x.device, x.data_ptr(), _DTYPES[x.dtype],
                 v.data_ptr(), s.data_ptr(), o.data_ptr(), n, num_groups,
                 group_size, q_max, 2.0 * q_max, _EPS, int(symmetric))
    quantize.launches += 1
    return QuantizedTensor(v, s, o, tuple(x.shape), x.dtype)


def dequantize(qt: QuantizedTensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``values * scale + offset`` in fp32, cast to ``qt.dtype``, as a
    tensor of ``qt.shape``; written into ``out`` (contiguous, of that
    shape and dtype) when given.  CPU tensors take
    :func:`dequantize_reference`; CUDA tensors launch the kernel once."""
    v, s, o = qt.values, qt.scale, qt.offset
    n = _numel(qt.shape)
    if v.dim() != 2 or v.dtype != torch.int8:
        raise ValueError(f"values must be int8 [groups, group_size], got "
                         f"{v.dtype} {tuple(v.shape)}")
    G, gs = v.shape
    if G != _num_groups(n, gs):
        raise ValueError(f"{G} groups of {gs} cannot hold shape {qt.shape}")
    for name, t in (("scale", s), ("offset", o)):
        if t.dtype != torch.float32 or t.shape != (G, 1):
            raise ValueError(f"{name} must be float32 [{G}, 1], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if qt.dtype not in _DTYPES:
        raise TypeError(f"dequantize writes bfloat16, float16 or float32, "
                        f"not {qt.dtype}")
    if out is not None and (out.shape != tuple(qt.shape) or
                            out.dtype != qt.dtype or
                            not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {qt.dtype} tensor of "
                         f"shape {tuple(qt.shape)}, got {out.dtype} "
                         f"{tuple(out.shape)}")
    tensors = [v, s, o] + ([] if out is None else [out])
    if any(t.device != v.device for t in tensors):
        raise ValueError("all tensors must be on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")
    if v.device.type == "cpu":
        return dequantize_reference(qt, out)
    _on_card(v, "dequantize")
    if not all(t.is_contiguous() for t in (v, s, o)):
        raise ValueError("the kernel reads contiguous tensors")
    if out is None:
        out = torch.empty(qt.shape, dtype=qt.dtype, device=v.device)
    _device_call("dstpu_dequantize", v.device, v.data_ptr(), s.data_ptr(),
                 o.data_ptr(), out.data_ptr(), _DTYPES[qt.dtype], n, gs)
    dequantize.launches += 1
    return out


quantize.launches = 0
dequantize.launches = 0
