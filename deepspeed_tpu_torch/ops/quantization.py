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
int8 pair: :func:`dequant_scaled` (fp8 and per-channel int8),
:func:`dequantize_fp6`, and W8A8's :func:`w8a8_quant_rows` and
:func:`w8a8_epilogue` around the int8 product (``torch._int_mm`` on the
card, exact float64 products in the plain version).  Each counts its
launches in ``.launches``.
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
# torch._int_mm on CUDA refuses 16 rows or fewer: W8A8 pads its activation
# rows up to this many with zero rows (which quantize to 0) and slices
_INT_MM_MIN_ROWS = 17
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
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        lib.dstpu_dequant_scaled.argtypes = [ptr, i32, ptr, i32, i64, ptr,
                                             i32, i64, ptr]
        lib.dstpu_dequant_fp6.argtypes = [ptr, ptr, ptr, i32, i64, i64, i32,
                                          ptr]
        lib.dstpu_w8a8_quant_rows.argtypes = [ptr, i32, ptr, ptr, i64, i64,
                                              i64, f32, f32, ptr]
        lib.dstpu_w8a8_epilogue.argtypes = [ptr, ptr, ptr, ptr, i32, i64,
                                            i64, ptr]
        for fn in (lib.dstpu_dequant_scaled, lib.dstpu_dequant_fp6,
                   lib.dstpu_w8a8_quant_rows, lib.dstpu_w8a8_epilogue):
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


def w8a8_quant_rows(x: torch.Tensor, rows_padded: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 quantization of ``x`` ``[M, K]`` (bf16, fp16 or
    fp32, contiguous): ``sx = max|x| / 127`` (fp32 ``[M, 1]``) and ``xq =
    clip(round(x / max(sx, 1e-12)), -127, 127)`` int8 ``[M, K]``.  On the
    card ``rows_padded`` (>= M) rows are written, the extra ones zero
    (with ``sx`` 0), for a product that needs more rows.  CPU tensors take
    :func:`w8a8_quant_rows_reference`; CUDA tensors launch kernel K3
    once."""
    if x.dtype not in _DTYPES or x.dim() != 2:
        raise TypeError(f"w8a8_quant_rows takes a 2-D bfloat16, float16 or "
                        f"float32 tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return w8a8_quant_rows_reference(x)
    _on_card(x, "w8a8_quant_rows")
    if not x.is_contiguous():
        raise ValueError("the kernel reads a contiguous tensor")
    M, K = x.shape
    Mp = M if rows_padded is None else int(rows_padded)
    if Mp < M:
        raise ValueError(f"rows_padded {Mp} < {M} rows")
    xq = torch.empty(Mp, K, dtype=torch.int8, device=x.device)
    sx = torch.empty(Mp, 1, dtype=torch.float32, device=x.device)
    if Mp == 0 or K == 0:
        return xq, sx.zero_()
    _device_call(_wf_lib(), "dstpu_w8a8_quant_rows", x.device, x.data_ptr(),
                 _DTYPES[x.dtype], xq.data_ptr(), sx.data_ptr(), M, Mp, K,
                 W8A8_Q_MAX, _EPS)
    w8a8_quant_rows.launches += 1
    return xq, sx


def w8a8_epilogue_reference(acc: torch.Tensor, sx: torch.Tensor,
                            s: torch.Tensor,
                            dtype: torch.dtype) -> torch.Tensor:
    """:func:`w8a8_epilogue` in plain PyTorch."""
    return (acc.float() * sx * s).to(dtype)


def w8a8_epilogue(acc: torch.Tensor, sx: torch.Tensor, s: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """``(float(acc) * sx) * s`` in fp32, cast to ``dtype``: ``acc`` int32
    ``[M, N]``, ``sx`` fp32 ``[M, 1]`` (a row's activation scale), ``s``
    fp32 ``[N]`` (a channel's weight scale).  CPU tensors take
    :func:`w8a8_epilogue_reference`; CUDA tensors launch kernel K4
    once."""
    M, N = acc.shape
    if acc.dtype != torch.int32:
        raise TypeError(f"acc must be int32, got {acc.dtype}")
    if (sx.dtype, tuple(sx.shape)) != (torch.float32, (M, 1)) or (
            s.dtype, tuple(s.shape)) != (torch.float32, (N,)):
        raise ValueError(f"sx must be float32 [{M}, 1] and s float32 [{N}], "
                         f"got {sx.dtype} {tuple(sx.shape)} and {s.dtype} "
                         f"{tuple(s.shape)}")
    if dtype not in _DTYPES:
        raise TypeError(f"w8a8_epilogue writes bfloat16, float16 or "
                        f"float32, not {dtype}")
    device = _same_device(acc, sx, s)
    if device.type == "cpu":
        return w8a8_epilogue_reference(acc, sx, s, dtype)
    _on_card(acc, "w8a8_epilogue")
    if not all(t.is_contiguous() for t in (acc, sx, s)):
        raise ValueError("the kernel reads contiguous tensors")
    y = torch.empty(M, N, dtype=dtype, device=device)
    if M == 0 or N == 0:
        return y
    _device_call(_wf_lib(), "dstpu_w8a8_epilogue", device, acc.data_ptr(),
                 sx.data_ptr(), s.data_ptr(), y.data_ptr(), _DTYPES[dtype],
                 M, N)
    w8a8_epilogue.launches += 1
    return y


def int8_product_reference(xq: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] @ v[N, K]^T`` with int32 results from exact float64
    products and sums (exact below 2^53, where fp32's 2^24 is not:
    127^2 x 14336 > 2^24), independent of cuBLAS's int8 path."""
    return (xq.double() @ v.double().t()).to(torch.int32)


def w8a8_linear_reference(x: torch.Tensor, v: torch.Tensor,
                          s: torch.Tensor) -> torch.Tensor:
    """:func:`w8a8_linear` in plain PyTorch."""
    shape = x.shape
    xq, sx = w8a8_quant_rows_reference(x.reshape(-1, shape[-1]))
    y = w8a8_epilogue_reference(int8_product_reference(xq, v), sx, s,
                                x.dtype)
    return y.reshape(*shape[:-1], v.shape[0])


def w8a8_linear(x: torch.Tensor, v: torch.Tensor,
                s: torch.Tensor) -> torch.Tensor:
    """``x [..., K]`` through a W8A8 weight (``v`` int8 ``[N, K]``, ``s``
    fp32 ``[N]``, :func:`quantize_per_channel`): the JAX
    ``w8a8_dot_general``.  Rows quantize by :func:`w8a8_quant_rows`, the
    int8 product accumulates in int32, and :func:`w8a8_epilogue` rescales
    into ``x``'s dtype.  On the card the product is ``torch._int_mm``
    against ``v``'s transpose (column-major), over at least
    ``_INT_MM_MIN_ROWS`` rows; on the CPU it is
    :func:`int8_product_reference`."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    M = x2.shape[0]
    if x2.device.type == "cpu":
        xq, sx = w8a8_quant_rows(x2)
        acc = int8_product_reference(xq, v)
    else:
        xq, sx = w8a8_quant_rows(x2.contiguous(),
                                 max(M, _INT_MM_MIN_ROWS))
        acc = torch._int_mm(xq, v.t())[:M]
        sx = sx[:M]
    y = w8a8_epilogue(acc, sx, s, x.dtype)
    return y.reshape(*shape[:-1], v.shape[0])


dequant_scaled.launches = 0
dequantize_fp6.launches = 0
w8a8_quant_rows.launches = 0
w8a8_epilogue.launches = 0
