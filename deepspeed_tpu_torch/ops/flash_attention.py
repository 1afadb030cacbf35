"""Flash attention forward for the H100.

Counterpart of ``deepspeed_tpu/ops/flash_attention.py``.  The TPU kernel
``_flash_fwd_kernel`` becomes the hand-written CUDA kernel in
``csrc/flash_fwd.cu`` (see the note at its top); beside it live the plain
PyTorch versions of the same functions:

- :func:`mha_reference`: naive O(S^2)-memory attention;
- :func:`flash_fwd_reference`: the blockwise online-softmax forward
  returning ``(out, lse)``, the counterpart of ``_blockwise_fwd`` and the
  arithmetic the kernel repeats;
- :func:`flash_fwd`: the wrapper.  CPU tensors take the plain version; a
  CUDA tensor launches the kernel or raises.  ``flash_fwd.launches`` counts
  kernel launches;
- :func:`flash_attention`: the public call with the JAX layout, q
  ``[B,H,S,D]`` and k, v ``[B,Hkv,Sk,D]`` (Hkv divides H).

Causal masks are bottom-right aligned (the last query sees the last key),
the KV-cache decode convention; a row that sees no key gives output 0 and
log-sum-exp ``+inf``.  There is no backward yet: serving needs none.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import builder

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
BLOCK = 64              # the kernel's q-tile and key-tile rows
_HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, sm_scale: Optional[float] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Naive attention in fp32.  q: [B,H,S,D]; k, v: [B,Hkv,Sk,D]."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    groups = q.shape[1] // k.shape[1]
    if groups > 1:
        k = k.repeat_interleave(groups, dim=1)
        v = v.repeat_interleave(groups, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if bias is not None:
        logits = logits + bias
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(
            diagonal=sk - sq)
        logits = logits.masked_fill(~mask, DEFAULT_MASK_VALUE)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def flash_fwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise online-softmax forward in plain PyTorch: ``(out, lse)``
    with out in q's dtype and lse fp32 ``[B,H,S]``.

    Scores are fp32 and scaled there; ``p`` enters the PV product in v's
    dtype, as in the kernel, over the kernel's 64-row tiles.  Key tiles
    wholly past a q tile's causal diagonal are skipped: for every row that
    sees a key they would add exactly nothing (p = 0, alpha = 1)."""
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    groups = H // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    # GQA without copies: [B, Hkv, groups, S, D] against [B, Hkv, 1, Sk, D]
    qf = q.float().reshape(B, Hkv, groups, S, D)
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    offset = Sk - S
    out = torch.empty(B, Hkv, groups, S, D, dtype=torch.float32,
                      device=q.device)
    lse = torch.empty(B, Hkv, groups, S, dtype=torch.float32, device=q.device)
    for q0 in range(0, S, BLOCK):
        q1 = min(q0 + BLOCK, S)
        qb = qf[..., q0:q1, :]
        qpos = torch.arange(q0, q1, device=q.device)
        m = torch.full(qb.shape[:-1], -math.inf, device=q.device)
        l = torch.zeros(qb.shape[:-1], device=q.device)
        acc = torch.zeros(qb.shape, device=q.device)
        k_end = min(Sk, max(0, q1 + offset)) if causal else Sk
        for k0 in range(0, k_end, BLOCK):
            k1 = min(k0 + BLOCK, Sk)
            s = qb @ kf[..., k0:k1, :].transpose(-1, -2) * sm_scale
            if causal:
                kpos = torch.arange(k0, k1, device=q.device)
                s = s.masked_fill(kpos[None, :] > qpos[:, None] + offset,
                                  DEFAULT_MASK_VALUE)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = p.to(v.dtype).float() @ vf[..., k0:k1, :]
            acc = acc * alpha[..., None] + pv
            m = m_new
        valid = m > DEFAULT_MASK_VALUE * 0.5
        lc = l.clamp_min(1e-30)
        out[..., q0:q1, :] = torch.where(valid[..., None], acc / lc[..., None],
                                         0.0)
        lse[..., q0:q1] = torch.where(valid, m + torch.log(lc), math.inf)
    return (out.reshape(B, H, S, D).to(q.dtype), lse.reshape(B, H, S))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q [B,H,S,D] and k, v [B,Hkv,Sk,D]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or S < 1 or k.shape[2] < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree on batch or head dim, or are empty")
    if H % k.shape[1]:
        raise ValueError(f"q heads {H} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want all "
                        "bfloat16 or all float32")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"tensors on {q.device}, {k.device}, {v.device}")


def _lib() -> ctypes.CDLL:
    lib = builder.load("flash_fwd")
    if lib.dstpu_flash_fwd.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dstpu_flash_fwd.argtypes = (
            [ptr] * 5 + [i32] * 7 + [i64] * 12 +
            [ctypes.c_float, i32, ptr])
        lib.dstpu_flash_fwd.restype = i32
        lib.dstpu_cuda_error_string.argtypes = [i32]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, causal: bool, sm_scale: float):
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                s % vec for s in t.stride()[:3]):
            raise ValueError(
                f"{name}: the kernel reads 16-byte rows; want a contiguous "
                f"head dim, a 16-byte aligned base and strides that are "
                f"multiples of {vec} (got strides {t.stride()})")
    # o is laid out [B,S,H,D] and returned as its [B,H,S,D] view, so the
    # caller's transpose back to [B,S,H*D] costs no copy
    o = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().dstpu_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _DTYPES[q.dtype], B, H, Hkv, S, Sk, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], float(sm_scale), int(causal), stream)
    if err:
        raise RuntimeError("flash_fwd launch failed: " +
                           _lib().dstpu_cuda_error_string(err).decode())
    return o, lse


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward: ``(out [B,H,S,D] in q's dtype, lse [B,H,S]
    fp32)``.  CPU tensors take :func:`flash_fwd_reference`; CUDA tensors
    launch the kernel on the current stream (bf16 or fp32, D in {64, 128})
    and count the launch in ``flash_fwd.launches``."""
    _check(q, k, v)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_fwd_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda or cpu, not {q.device}")
    out = _launch(q, k, v, causal, sm_scale)
    flash_fwd.launches += 1
    return out


flash_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Flash attention.  q: [B, H, S, D]; k, v: [B, Hkv, Sk, D] where Hkv
    divides H (grouped-query attention).  Returns [B, H, S, D] in q.dtype."""
    return flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale)[0]
