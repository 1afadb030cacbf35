"""Ragged paged attention for the H100: the two kernels of the v2 serving
path.

- :func:`ragged_paged_attention` (full-width pages, bf16 or fp32) stands
  where the JAX package calls upstream's vLLM-TPU Pallas kernel
  (``deepspeed_tpu/inference/paged.py:602-609``);
- :func:`ragged_paged_attention_quant` (int8 or fp8-e4m3 pages with fp32
  scales) is the counterpart of ``deepspeed_tpu/ops/ragged_paged_quant.py``
  (``_quant_kernel``).

Both are one hand-written CUDA source, ``csrc/ragged_paged_attn.cu``
(see the note at its top), templated on the page type.  CPU tensors take
the plain versions, :func:`~deepspeed_tpu_torch.inference.paged.
ref_paged_attention` and :func:`~deepspeed_tpu_torch.inference.paged.
ref_paged_attention_quant`; a CUDA tensor launches the kernel or raises.
Each function counts its kernel launches in ``.launches``.  The wrappers
never read a device value on the host, so they can run inside a captured
decode block.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.inference.paged import (ref_paged_attention,
                                                 ref_paged_attention_quant)
from deepspeed_tpu_torch.ops import builder

_HEAD_DIMS = (64, 128)
PAGE_SIZES = (16, 32, 64, 128)
MAX_GROUP = 64          # q heads per KV head: the kernel's 64-row tile
_Q_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_PAGE_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2,
                torch.float8_e4m3fn: 3}
_QUANT = (torch.int8, torch.float8_e4m3fn)


def _check(q, pages, scales, kv_lens, page_indices, cu_q_lens, num_seqs,
           sliding_window) -> None:
    if q.dim() != 3 or pages.dim() != 4:
        raise ValueError(f"want q [T,H,D] and pages [P,page,2*Hkv,D]; got "
                         f"{tuple(q.shape)}, {tuple(pages.shape)}")
    T, H, D = q.shape
    P, page, combined, Dp = pages.shape
    if Dp != D or combined % 2 or T < 1:
        raise ValueError(f"q {tuple(q.shape)} and pages "
                         f"{tuple(pages.shape)} disagree")
    Hkv = combined // 2
    if H % Hkv or H // Hkv > MAX_GROUP:
        raise ValueError(f"q heads {H} must be a multiple of kv heads "
                         f"{Hkv}, at most {MAX_GROUP} per kv head")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if page not in PAGE_SIZES:
        raise ValueError(f"page size {page} not in {PAGE_SIZES}")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"q dtype {q.dtype}: want bfloat16 or float32")
    S = kv_lens.shape[0]
    if (page_indices.dim() != 2 or page_indices.shape[0] != S
            or cu_q_lens.shape != (S + 1,) or num_seqs.shape != (1,)):
        raise ValueError(
            f"metadata shapes kv_lens {tuple(kv_lens.shape)}, page_indices "
            f"{tuple(page_indices.shape)}, cu_q_lens "
            f"{tuple(cu_q_lens.shape)}, num_seqs {tuple(num_seqs.shape)}")
    for name, t in (("kv_lens", kv_lens), ("page_indices", page_indices),
                    ("cu_q_lens", cu_q_lens), ("num_seqs", num_seqs)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if scales is not None and (scales.dtype != torch.float32 or
                               scales.shape != pages.shape[:3]):
        raise ValueError(f"scales must be float32 {tuple(pages.shape[:3])}"
                         f", got {scales.dtype} {tuple(scales.shape)}")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"sliding_window {sliding_window} must be >= 1")
    tensors = [q, pages, kv_lens, page_indices, cu_q_lens, num_seqs]
    if scales is not None:
        tensors.append(scales)
    if any(t.device != q.device for t in tensors):
        raise ValueError("all tensors must be on one device, got "
                         f"{sorted({str(t.device) for t in tensors})}")


def _lib() -> ctypes.CDLL:
    lib = builder.load("ragged_paged_attn")
    if lib.dstpu_ragged_paged_attn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.dstpu_ragged_paged_attn.argtypes = (
            [ptr] * 8 + [i32] * 10 + [ctypes.c_float, ptr])
        lib.dstpu_ragged_paged_attn.restype = i32
        lib.dstpu_cuda_error_string.argtypes = [i32]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, pages, scales, kv_lens, page_indices, cu_q_lens, num_seqs,
            sm_scale: float, sliding_window: Optional[int]) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"ragged paged attention runs on cuda or cpu, not "
                         f"{q.device}")
    tensors = [q, pages, kv_lens, page_indices, cu_q_lens, num_seqs]
    if scales is not None:
        tensors.append(scales)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel reads contiguous tensors")
    T, H, D = q.shape
    P, page, combined, _ = pages.shape
    S, pp = page_indices.shape
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().dstpu_ragged_paged_attn(
            q.data_ptr(), pages.data_ptr(),
            None if scales is None else scales.data_ptr(), o.data_ptr(),
            kv_lens.data_ptr(), page_indices.data_ptr(),
            cu_q_lens.data_ptr(), num_seqs.data_ptr(),
            _Q_DTYPES[q.dtype], _PAGE_DTYPES[pages.dtype], T, H,
            combined // 2, D, S, pp, page,
            0 if sliding_window is None else int(sliding_window),
            float(sm_scale), stream)
    if err:
        raise RuntimeError("ragged paged attention launch failed: " +
                           _lib().dstpu_cuda_error_string(err).decode())
    return o


def ragged_paged_attention(q: torch.Tensor, pages: torch.Tensor,
                           kv_lens: torch.Tensor, page_indices: torch.Tensor,
                           cu_q_lens: torch.Tensor, num_seqs: torch.Tensor,
                           *, sm_scale: float,
                           sliding_window: Optional[int] = None
                           ) -> torch.Tensor:
    """Attention of one fused tick's tokens ``q [T,H,D]`` over full-width
    pages ``[P,page,2*Hkv,D]`` of q's dtype (bf16 or fp32), through the
    page table; returns ``[T,H,D]`` in q's dtype.  Metadata (int32):
    ``kv_lens [S]``, ``page_indices [S,pp]`` (-1 = padding or hole),
    ``cu_q_lens [S+1]``, ``num_seqs [1]``.  D in {64, 128}, page in
    {16, 32, 64, 128}.  CPU tensors take :func:`ref_paged_attention`."""
    _check(q, pages, None, kv_lens, page_indices, cu_q_lens, num_seqs,
           sliding_window)
    if pages.dtype != q.dtype:
        raise TypeError(f"full-width pages must have q's dtype {q.dtype}, "
                        f"got {pages.dtype}")
    if q.device.type == "cpu":
        return ref_paged_attention(q, pages, kv_lens, page_indices,
                                   cu_q_lens, num_seqs, sm_scale=sm_scale,
                                   sliding_window=sliding_window)
    out = _launch(q, pages, None, kv_lens, page_indices, cu_q_lens,
                  num_seqs, sm_scale, sliding_window)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0


def ragged_paged_attention_quant(q: torch.Tensor, pages: torch.Tensor,
                                 scales: torch.Tensor, kv_lens: torch.Tensor,
                                 page_indices: torch.Tensor,
                                 cu_q_lens: torch.Tensor,
                                 num_seqs: torch.Tensor, *, sm_scale: float,
                                 sliding_window: Optional[int] = None
                                 ) -> torch.Tensor:
    """:func:`ragged_paged_attention` over a quantized pool: ``pages``
    int8 or float8_e4m3fn and ``scales [P,page,2*Hkv]`` fp32, one scale
    per (row, combined head).  The pages are read 1 byte wide; q may be
    bf16 or fp32.  CPU tensors take :func:`ref_paged_attention_quant`."""
    _check(q, pages, scales, kv_lens, page_indices, cu_q_lens, num_seqs,
           sliding_window)
    if pages.dtype not in _QUANT:
        raise TypeError(f"quantized pages must be int8 or float8_e4m3fn, "
                        f"got {pages.dtype}")
    if q.device.type == "cpu":
        return ref_paged_attention_quant(
            q, pages, scales, kv_lens, page_indices, cu_q_lens, num_seqs,
            sm_scale=sm_scale, sliding_window=sliding_window)
    out = _launch(q, pages, scales, kv_lens, page_indices, cu_q_lens,
                  num_seqs, sm_scale, sliding_window)
    ragged_paged_attention_quant.launches += 1
    return out


ragged_paged_attention_quant.launches = 0
