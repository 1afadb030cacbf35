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
``dequantize.launches`` count launches.

The serving weight formats of the JAX module that are plain array code
there, not Pallas kernels, follow it one operation for one: fp8 (e4m3,
one fp32 scale a tensor: :func:`quantize_fp8`), fp6 (e3m2 packed four
codes to three bytes, one fp32 scale a group: :func:`quantize_fp6`) and
the W8A8 pieces of ``deepspeed_tpu/inference/quantization.py``
(:func:`quantize_per_channel`, the weight branch of ``quantize_param_tree``;
:func:`w8a8_linear`, ``w8a8_dot_general``).  Quantizing runs once a weight
when an engine is built and stays PyTorch operations, as the JAX package
leaves it to XLA.  What runs at every use is a hand-written kernel of
``csrc/weight_formats.cu`` beside its plain version, dispatched like the
int8 pair: :func:`dequant_scaled` (fp8 and per-channel int8) and
:func:`dequantize_fp6`.  A W8A8 Linear is two kernels of
``csrc/w8a8_gemm.cu``: the row pre-pass :func:`w8a8_quant_rows` and the
GEMM of :func:`w8a8_gemm` (an int8 ``wgmma`` product with the rescale in
its epilogue), which may start while the pre-pass runs; its plain version
chains the plain row quantization, exact float64 int8 products and the
plain rescale.  Each counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import functools
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


def _device_call(lib: ctypes.CDLL, fn_name: str, device: torch.device,
                 *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: " +
                           lib.dstpu_cuda_error_string(err).decode())


def _on_card(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")


def _same_device(*tensors: Optional[torch.Tensor]) -> torch.device:
    ts = [t for t in tensors if t is not None]
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("all tensors must be on one device, got "
                         f"{sorted({str(t.device) for t in ts})}")
    return ts[0].device


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
    _device_call(_lib(), "dstpu_quantize", x.device, x.data_ptr(),
                 _DTYPES[x.dtype], v.data_ptr(), s.data_ptr(), o.data_ptr(),
                 n, num_groups, group_size, q_max, 2.0 * q_max, _EPS,
                 int(symmetric))
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
    _same_device(v, s, o, out)
    if v.device.type == "cpu":
        return dequantize_reference(qt, out)
    _on_card(v, "dequantize")
    if not all(t.is_contiguous() for t in (v, s, o)):
        raise ValueError("the kernel reads contiguous tensors")
    if out is None:
        out = torch.empty(qt.shape, dtype=qt.dtype, device=v.device)
    _device_call(_lib(), "dstpu_dequantize", v.device, v.data_ptr(),
                 s.data_ptr(), o.data_ptr(), out.data_ptr(), _DTYPES[qt.dtype],
                 n, gs)
    dequantize.launches += 1
    return out


quantize.launches = 0
dequantize.launches = 0


# ---------------------------------------------------------------------------
# fp8, fp6 and W8A8: the serving weight formats (csrc/weight_formats.cu)
# ---------------------------------------------------------------------------

FP8_MAX = float(torch.finfo(torch.float8_e4m3fn).max)     # 448
FP6_MAX = 28.0                       # (1 + 3/4) * 2^(7-3)
_FP6_BIAS = 3
W8A8_Q_MAX = 127.0
_VTYPES = {torch.int8: 0, torch.float8_e4m3fn: 1}


class FP8Tensor(NamedTuple):
    """float8_e4m3fn payload of the tensor's shape + one fp32 scale."""
    values: torch.Tensor     # float8_e4m3fn, ``shape``
    scale: torch.Tensor      # fp32 scalar (0-d)
    shape: Tuple[int, ...]
    dtype: torch.dtype


class FP6Tensor(NamedTuple):
    """fp6 e3m2 codes packed 4 to 3 bytes + one fp32 scale a group."""
    values: torch.Tensor     # uint8 [num_groups, group_size * 3 // 4]
    scale: torch.Tensor      # fp32 [num_groups, 1]
    shape: Tuple[int, ...]
    dtype: torch.dtype
    group_size: int


def _const(v: float, device) -> torch.Tensor:
    # a divisor as a device tensor (see quantize_reference)
    return torch.tensor(v, dtype=torch.float32, device=device)


def quantize_fp8(x: torch.Tensor) -> FP8Tensor:
    """Per-tensor fp8: ``scale = max(max|x|, 1e-12) / 448``, payload
    ``x / scale`` cast to e4m3 (round to nearest even), as the JAX
    ``quantize_fp8``."""
    xf = x.float()
    scale = xf.abs().amax().clamp_min(_EPS) / _const(FP8_MAX, x.device)
    v = (xf / scale).to(torch.float8_e4m3fn)
    return FP8Tensor(v, scale, tuple(x.shape), x.dtype)


def dequantize_fp8(ft: FP8Tensor) -> torch.Tensor:
    """``values * scale`` in fp32, cast to ``ft.dtype``: one
    :func:`dequant_scaled` launch on the card."""
    return dequant_scaled(ft.values, ft.scale, ft.dtype)


def _fp6_encode(a: torch.Tensor) -> torch.Tensor:
    """|x| in [0, FP6_MAX] -> 5-bit magnitude code (3 exponent | 2
    mantissa bits), round to nearest, as the JAX ``_fp6_encode``."""
    a = a.clamp(0.0, FP6_MAX)
    e = torch.floor(torch.log2(a.clamp_min(1e-30)))
    e = e.clamp(1 - _FP6_BIAS, 4)                  # normal exponents
    sub = a < 2.0 ** (1 - _FP6_BIAS)               # subnormal range
    # subnormal: a = m/4 * 2^(1-bias) -> m = a * 16
    m_sub = torch.round(a * (4.0 / 2.0 ** (1 - _FP6_BIAS)))
    # normal: a = (1 + m/4) * 2^e -> m = (a/2^e - 1) * 4 (exact powers)
    m_norm = torch.round((a / torch.exp2(e) - 1.0) * 4.0)
    # mantissa rounding overflow (m == 4) bumps the exponent
    bump = m_norm >= 4.0
    e = torch.where(bump, e + 1.0, e)
    m_norm = torch.where(bump, 0.0, m_norm)
    over = e > 4.0
    e = torch.where(over, 4.0, e)
    m_norm = torch.where(over, 3.0, m_norm)
    exp_bits = torch.where(sub, 0.0, e + _FP6_BIAS)
    m = torch.where(sub, torch.clamp_max(m_sub, 3.0), m_norm)
    return (exp_bits.to(torch.uint8) << 2) | m.to(torch.uint8)


def _fp6_decode(code: torch.Tensor) -> torch.Tensor:
    """5-bit magnitude code -> fp32 value, exactly."""
    exp_bits = (code >> 2) & 0x7
    m = (code & 0x3).float()
    val_sub = m / 4.0 * 2.0 ** (1 - _FP6_BIAS)
    val_norm = (1.0 + m / 4.0) * torch.exp2(exp_bits.float() - _FP6_BIAS)
    return torch.where(exp_bits == 0, val_sub, val_norm)


def _pack6(codes: torch.Tensor) -> torch.Tensor:
    """[G, gs] 6-bit codes -> [G, gs*3/4] bytes (4 codes in 3 bytes,
    little-endian in a 24-bit word)."""
    g, gs = codes.shape
    q = codes.reshape(g, gs // 4, 4).to(torch.int32)
    word = q[..., 0] | (q[..., 1] << 6) | (q[..., 2] << 12) | (q[..., 3] << 18)
    return torch.stack([word & 0xFF, (word >> 8) & 0xFF,
                        (word >> 16) & 0xFF], dim=-1).to(
        torch.uint8).reshape(g, gs * 3 // 4)


def _unpack6(packed: torch.Tensor, group_size: int) -> torch.Tensor:
    g = packed.shape[0]
    b = packed.reshape(g, group_size // 4, 3).to(torch.int32)
    word = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    return torch.stack([word & 0x3F, (word >> 6) & 0x3F,
                        (word >> 12) & 0x3F, (word >> 18) & 0x3F],
                       dim=-1).reshape(g, group_size).to(torch.uint8)


def _fp6_group_size(numel: int, group_size: int) -> Tuple[int, int]:
    """The JAX ``quantize_fp6``'s group size for ``numel`` values: the
    largest ``gs <= group_size`` that divides ``numel`` and is a multiple
    of 4, down to 4; else groups of 4 over ``numel`` padded to a multiple
    of 4.  Returns ``(gs, padding)``."""
    gs = group_size
    while gs > 4 and (numel % gs or gs % 4):
        gs -= 1
    if numel % gs or gs % 4:
        return 4, (-numel) % 4
    return gs, 0


def quantize_fp6(x: torch.Tensor, group_size: int = 512) -> FP6Tensor:
    """Group-wise fp6 e3m2 (the reference's FP6-LLM weight format): each
    group scales its absmax onto ``FP6_MAX``, values round to the fp6 grid
    and pack 6 bits each, as the JAX ``quantize_fp6``."""
    flat = x.reshape(-1).float()
    gs, pad = _fp6_group_size(flat.numel(), group_size)
    groups = F.pad(flat, (0, pad)).view(-1, gs)
    absmax = groups.abs().amax(dim=1, keepdim=True).clamp_min(_EPS)
    scale = absmax / _const(FP6_MAX, x.device)
    scaled = groups / scale
    sign = (scaled < 0).to(torch.uint8) << 5
    codes = sign | _fp6_encode(scaled.abs())
    return FP6Tensor(_pack6(codes), scale, tuple(x.shape), x.dtype, gs)


def dequantize_fp6_reference(ft: FP6Tensor) -> torch.Tensor:
    """:func:`dequantize_fp6` in plain PyTorch (the JAX
    ``dequantize_fp6``)."""
    codes = _unpack6(ft.values, ft.group_size)
    mag = _fp6_decode(codes)
    sign = torch.where((codes >> 5) & 1 == 1, -1.0, 1.0)
    x = sign * mag * ft.scale
    n = _numel(ft.shape)
    return x.reshape(-1)[:n].reshape(ft.shape).to(ft.dtype)


def _wf_lib() -> ctypes.CDLL:
    lib = builder.load("weight_formats")
    if lib.dstpu_dequant_scaled.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dstpu_dequant_scaled.argtypes = [ptr, i32, ptr, i32, i64, ptr,
                                             i32, i64, ptr]
        lib.dstpu_dequant_fp6.argtypes = [ptr, ptr, ptr, i32, i64, i64, i32,
                                          ptr]
        for fn in (lib.dstpu_dequant_scaled, lib.dstpu_dequant_fp6):
            fn.restype = i32
        lib.dstpu_cuda_error_string.argtypes = [i32]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _per_row(v: torch.Tensor, s: torch.Tensor) -> bool:
    """Whether ``s`` scales ``v`` per row (``[R]`` over ``[R, C]``), not
    per tensor (one value)."""
    if s.numel() == 1 and s.dim() <= 1:
        return False
    if v.dim() == 2 and tuple(s.shape) == (v.shape[0],):
        return True
    raise ValueError(f"scale of shape {tuple(s.shape)} is neither one value "
                     f"nor one a row of {tuple(v.shape)}")


def dequant_scaled_reference(v: torch.Tensor, s: torch.Tensor,
                             dtype: torch.dtype) -> torch.Tensor:
    """:func:`dequant_scaled` in plain PyTorch: ``v * s`` in fp32, cast to
    ``dtype`` (the JAX ``dequantize_fp8`` and the w8a8 branch of
    ``dequantize_param_tree``)."""
    x = v.float() * (s[:, None] if _per_row(v, s) else s.reshape(()))
    return x.to(dtype)


def dequant_scaled(v: torch.Tensor, s: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """``v`` (int8 or float8_e4m3fn, contiguous) times ``s`` (fp32: one
    value, or one a row of a 2-D ``v``) in fp32, cast to ``dtype``, as a
    tensor of ``v``'s shape.  CPU tensors take
    :func:`dequant_scaled_reference`; CUDA tensors launch kernel K1
    once."""
    if v.dtype not in _VTYPES:
        raise TypeError(f"dequant_scaled reads int8 or float8_e4m3fn, got "
                        f"{v.dtype}")
    if s.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {s.dtype}")
    if dtype not in _DTYPES:
        raise TypeError(f"dequant_scaled writes bfloat16, float16 or "
                        f"float32, not {dtype}")
    per_row = _per_row(v, s)
    device = _same_device(v, s)
    if device.type == "cpu":
        return dequant_scaled_reference(v, s, dtype)
    _on_card(v, "dequant_scaled")
    if not (v.is_contiguous() and s.is_contiguous()):
        raise ValueError("the kernel reads contiguous tensors")
    out = torch.empty(v.shape, dtype=dtype, device=device)
    if v.numel() == 0:
        return out
    cols = v.shape[1] if per_row else 1
    _device_call(_wf_lib(), "dstpu_dequant_scaled", device, v.data_ptr(),
                 _VTYPES[v.dtype], s.data_ptr(), int(per_row), cols,
                 out.data_ptr(), _DTYPES[dtype], v.numel())
    dequant_scaled.launches += 1
    return out


def dequantize_fp6(ft: FP6Tensor) -> torch.Tensor:
    """The fp6 tensor's values times their group's scale, cast to
    ``ft.dtype``, as a tensor of ``ft.shape`` (the first ``n`` codes).
    CPU tensors take :func:`dequantize_fp6_reference`; CUDA tensors launch
    kernel K2 once."""
    p, s, gs = ft.values, ft.scale, int(ft.group_size)
    if gs < 4 or gs % 4:
        raise ValueError(f"fp6 groups hold a multiple of 4 codes, got {gs}")
    if p.dtype != torch.uint8 or p.dim() != 2 or p.shape[1] != gs * 3 // 4:
        raise ValueError(f"values must be uint8 [groups, {gs * 3 // 4}], got "
                         f"{p.dtype} {tuple(p.shape)}")
    G = p.shape[0]
    n = _numel(ft.shape)
    if not n <= G * gs < n + 4:
        raise ValueError(f"{G} groups of {gs} cannot hold shape {ft.shape}")
    if s.dtype != torch.float32 or s.shape != (G, 1):
        raise ValueError(f"scale must be float32 [{G}, 1], got {s.dtype} "
                         f"{tuple(s.shape)}")
    if ft.dtype not in _DTYPES:
        raise TypeError(f"dequantize_fp6 writes bfloat16, float16 or float32, "
                        f"not {ft.dtype}")
    device = _same_device(p, s)
    if device.type == "cpu":
        return dequantize_fp6_reference(ft)
    _on_card(p, "dequantize_fp6")
    if not (p.is_contiguous() and s.is_contiguous()):
        raise ValueError("the kernel reads contiguous tensors")
    out = torch.empty(ft.shape, dtype=ft.dtype, device=device)
    if n == 0:
        return out
    _device_call(_wf_lib(), "dstpu_dequant_fp6", device, p.data_ptr(),
                 s.data_ptr(), out.data_ptr(), _DTYPES[ft.dtype], n, G * gs,
                 gs)
    dequantize_fp6.launches += 1
    return out



def quantize_per_channel(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """W8A8's weight format for an ``nn.Linear`` weight ``[out, in]``:
    one symmetric fp32 scale an output channel, ``s = max(max|w|, 1e-12)
    / 127``, payload ``clip(round(w / s), -127, 127)`` int8 ``[out, in]``
    (the w8a8 branch of the JAX ``quantize_param_tree`` on flax's ``[in,
    out]`` kernel, transposed)."""
    wf = w.float()
    s = wf.abs().amax(dim=1).clamp_min(_EPS) / _const(W8A8_Q_MAX, w.device)
    v = torch.clamp(torch.round(wf / s[:, None]), -W8A8_Q_MAX,
                    W8A8_Q_MAX).to(torch.int8)
    return v, s


def w8a8_quant_rows_reference(x: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`w8a8_quant_rows` in plain PyTorch (the activation half of
    the JAX ``w8a8_dot_general``)."""
    xf = x.float()
    sx = xf.abs().amax(dim=-1, keepdim=True) / _const(W8A8_Q_MAX, x.device)
    xq = torch.clamp(torch.round(xf / sx.clamp_min(_EPS)), -W8A8_Q_MAX,
                     W8A8_Q_MAX).to(torch.int8)
    return xq, sx


def _gemm_lib() -> ctypes.CDLL:
    lib = builder.load("w8a8_gemm")
    if lib.dstpu_w8a8_gemm.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dstpu_w8a8_rows.argtypes = [ptr, i32, ptr, ptr, i64, i64, ptr]
        lib.dstpu_w8a8_gemm.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr,
                                        ptr, i64, i64, i64, i32, i32, i32,
                                        i32, ptr]
        for fn in (lib.dstpu_w8a8_rows, lib.dstpu_w8a8_gemm):
            fn.restype = i32
        lib.dstpu_cuda_error_string.argtypes = [i32]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _w8a8_card_k(K: int) -> None:
    """The card's W8A8 kernels read int8 rows by TMA, whose row pitch must
    be a multiple of 16 bytes."""
    if K <= 0 or K % 16:
        raise ValueError(
            f"the W8A8 kernels take K (in features) a positive multiple of "
            f"16 on the card, got {K}: TMA reads the int8 rows in 16-byte "
            "units (ROADMAP B10 would widen this)")


def w8a8_quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 quantization of ``x`` ``[M, K]`` (bf16, fp16 or
    fp32): ``sx = max|x| / 127`` (fp32 ``[M, 1]``) and ``xq =
    clip(round(x / max(sx, 1e-12)), -127, 127)`` int8 ``[M, K]``: the row
    pre-pass of :func:`w8a8_gemm`.  CPU tensors take
    :func:`w8a8_quant_rows_reference`; CUDA tensors (contiguous, 16-byte
    aligned, K a multiple of 16) launch the pre-pass once."""
    if x.dtype not in _DTYPES or x.dim() != 2:
        raise TypeError(f"w8a8_quant_rows takes a 2-D bfloat16, float16 or "
                        f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return w8a8_quant_rows_reference(x)
    _on_card(x, "w8a8_quant_rows")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the kernel reads a contiguous, 16-byte aligned "
                         "tensor")
    M, K = x.shape
    xq = torch.empty(M, K, dtype=torch.int8, device=x.device)
    sx = torch.empty(M, 1, dtype=torch.float32, device=x.device)
    if M == 0 or K == 0:
        return xq, sx.zero_()
    _w8a8_card_k(K)
    _device_call(_gemm_lib(), "dstpu_w8a8_rows", x.device, x.data_ptr(),
                 _DTYPES[x.dtype], xq.data_ptr(), sx.data_ptr(), M, K)
    w8a8_quant_rows.launches += 1
    return xq, sx


def w8a8_epilogue_reference(acc: torch.Tensor, sx: torch.Tensor,
                            s: torch.Tensor,
                            dtype: torch.dtype) -> torch.Tensor:
    """The rescale of an int32 product ``acc`` ``[M, N]``: ``(float(acc) *
    sx) * s`` in fp32 (``sx`` ``[M, 1]`` a row's activation scale, ``s``
    ``[N]`` a channel's weight scale), cast to ``dtype``."""
    return (acc.float() * sx * s).to(dtype)


def int8_product_reference(xq: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] @ v[N, K]^T`` with int32 results from exact float64
    products and sums (exact below 2^53, where fp32's 2^24 is not:
    127^2 x 14336 > 2^24), independent of any int8 GEMM."""
    return (xq.double() @ v.double().t()).to(torch.int32)


def w8a8_linear_reference(x: torch.Tensor, v: torch.Tensor,
                          s: torch.Tensor) -> torch.Tensor:
    """:func:`w8a8_linear` in plain PyTorch."""
    shape = x.shape
    xq, sx = w8a8_quant_rows_reference(x.reshape(-1, shape[-1]))
    y = w8a8_epilogue_reference(int8_product_reference(xq, v), sx, s,
                                x.dtype)
    return y.reshape(*shape[:-1], v.shape[0])


# The W8A8 GEMM's tiling (csrc/w8a8_gemm.cu): 128 output channels a tile,
# K in 128-byte panels, the tokens one tile of 16, 32 or 64 rows (one
# block an SM over equal shares of the work: stream-K) or tiles of 128 or
# 256 (a block a tile and K range).
W8A8_STREAM_MAX_ROWS = 64
_W8A8_TILE = 128


class W8A8Plan(NamedTuple):
    """How :func:`w8a8_gemm` cuts one call into blocks."""
    tn: int              # token rows a tile: the wgmma's N
    token_tiles: int
    tiles: int           # 128-channel tiles
    ksplit: int          # 128/256-token tiles: K ranges, a block each
    kr: int              # 128/256-token tiles: values of K a range
    blocks: int          # the grid's blocks


def w8a8_plan(M: int, N: int, K: int, sms: int = 132) -> W8A8Plan:
    """The blocks of an ``[M, K] x [N, K]^T`` call on a card of ``sms``
    SMs.  Up to ``W8A8_STREAM_MAX_ROWS`` rows the tokens, padded to 16,
    32 or 64, are one tile, and one block an SM takes an equal share of
    the tiles' K panels (stream-K).  Above, 128-token tiles up to 128
    rows and 256-token ones beyond, a block a (channel tile, K range,
    token tile), K split only where the tiles leave SMs idle, into
    ranges of at least 8 panels."""
    tiles = -(-N // _W8A8_TILE)
    panels = max(1, -(-K // 128))
    if M <= W8A8_STREAM_MAX_ROWS:
        tn = next(t for t in (16, 32, 64) if M <= t)
        return W8A8Plan(tn, 1, tiles, 1, panels * 128,
                        min(sms, tiles * panels))
    tn = 128 if M <= 128 else 256
    token_tiles = -(-M // tn)
    # a K range of at least 8 panels: each split adds a 128 x tn int32
    # partial to the tile's sums
    ksplit = min(max(1, sms // (tiles * token_tiles)), max(1, panels // 8))
    kr = -(-panels // ksplit) * 128
    ksplit = -(-K // kr)
    return W8A8Plan(tn, token_tiles, tiles, ksplit, kr,
                    tiles * ksplit * token_tiles)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The split-K hand-off's zeroed int32 buffers, which every call leaves
# zeroed: a ticket and 128 x tn sums a (token tile, channel tile).  A
# buffer is never freed, since a captured CUDA graph keeps its address,
# and grows only outside a capture.  Calls on one device share them, so
# they run on one stream at a time.
_WORKSPACE: dict = {}


def _zeroed(device: torch.device, kind: str, n: int) -> torch.Tensor:
    held = _WORKSPACE.setdefault((device, kind), [])
    if not held or held[-1].numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"w8a8_gemm needs {n} {kind} during a graph capture, more "
                "than it holds; run the call once before capturing it")
        grown = 2 * held[-1].numel() if held else 1 << 16
        held.append(torch.zeros(max(n, grown), dtype=torch.int32,
                                device=device))
    return held[-1]


def w8a8_gemm(x: torch.Tensor, v: torch.Tensor,
              s: torch.Tensor) -> torch.Tensor:
    """``y [M, N]`` in ``x``'s dtype for ``x [M, K]`` (bf16, fp16 or fp32)
    through a W8A8 weight (``v`` int8 ``[N, K]``, ``s`` fp32 ``[N]``,
    :func:`quantize_per_channel`): the JAX ``w8a8_dot_general``, bit for
    bit.  CPU tensors take :func:`w8a8_linear_reference`.  CUDA tensors
    (K a multiple of 16) launch the row pre-pass (:func:`w8a8_quant_rows`)
    and then the GEMM kernel once, which may start while the pre-pass
    runs; :func:`w8a8_plan` cuts the call into blocks."""
    if x.dtype not in _DTYPES or x.dim() != 2:
        raise TypeError(f"w8a8_gemm takes a 2-D bfloat16, float16 or "
                        f"float32 x, got {x.dtype} {tuple(x.shape)}")
    if v.dtype != torch.int8 or v.dim() != 2 or v.shape[1] != x.shape[1]:
        raise ValueError(f"v must be int8 [N, {x.shape[1]}], got {v.dtype} "
                         f"{tuple(v.shape)}")
    if s.dtype != torch.float32 or tuple(s.shape) != (v.shape[0],):
        raise ValueError(f"s must be float32 [{v.shape[0]}], got {s.dtype} "
                         f"{tuple(s.shape)}")
    device = _same_device(x, v, s)
    if device.type == "cpu":
        return w8a8_linear_reference(x, v, s)
    _on_card(x, "w8a8_gemm")
    if not (v.is_contiguous() and s.is_contiguous()) or v.data_ptr() % 16:
        raise ValueError("the kernel reads a contiguous, 16-byte aligned "
                         "weight and contiguous scales")
    M, K = x.shape
    N = v.shape[0]
    _w8a8_card_k(K)
    y = torch.empty(M, N, dtype=x.dtype, device=device)
    if M == 0 or N == 0:
        return y
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    xq, sx = w8a8_quant_rows(x)
    plan = w8a8_plan(M, N, K, _sm_count(device.index))
    units = plan.token_tiles * plan.tiles
    sums = _zeroed(device, "sums", units * plan.tn * _W8A8_TILE)
    tickets = _zeroed(device, "tickets", units)
    _device_call(_gemm_lib(), "dstpu_w8a8_gemm", device, xq.data_ptr(),
                 sx.data_ptr(), _DTYPES[x.dtype], v.data_ptr(), s.data_ptr(),
                 y.data_ptr(), sums.data_ptr(), tickets.data_ptr(), M, N, K,
                 plan.tn, plan.ksplit, plan.kr, plan.blocks)
    w8a8_gemm.launches += 1
    return y


def w8a8_linear(x: torch.Tensor, v: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """``x [..., K]`` through a W8A8 weight (``v`` int8 ``[N, K]``, ``s``
    fp32 ``[N]``, :func:`quantize_per_channel`): the JAX
    ``w8a8_dot_general``, as :func:`w8a8_gemm` over the rows of ``x``."""
    shape = x.shape
    y = w8a8_gemm(x.reshape(-1, shape[-1]), v, s)
    return y.reshape(*shape[:-1], v.shape[0])


dequant_scaled.launches = 0
dequantize_fp6.launches = 0
w8a8_quant_rows.launches = 0
w8a8_gemm.launches = 0
