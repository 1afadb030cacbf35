"""Flash attention, forward and backward, for the H100.

Counterpart of ``deepspeed_tpu/ops/flash_attention.py``.  The TPU kernel
``_flash_fwd_kernel`` becomes the hand-written CUDA kernel in
``csrc/flash_fwd.cu``, and ``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel`` (with the GQA group sum of ``_flash_vjp_bwd``)
become the two kernels of ``csrc/flash_bwd.cu``; in bf16 all three are
persistent TMA + ``wgmma`` kernels on ``csrc/hopper.cuh`` (see the notes
at the sources' tops).  Beside them live the plain PyTorch versions of the
same functions:

- :func:`mha_reference`: naive O(S^2)-memory attention;
- :func:`flash_fwd_reference`: the blockwise online-softmax forward
  returning ``(out, lse)``, the counterpart of ``_blockwise_fwd`` and the
  arithmetic the kernel repeats;
- :func:`flash_fwd`: the wrapper.  CPU tensors take the plain version; a
  CUDA tensor launches the kernel or raises.  ``flash_fwd.launches`` counts
  kernel launches;
- :func:`flash_bwd_reference`: the blockwise backward recomputing P from
  the saved log-sum-exp, the counterpart of ``_blockwise_bwd`` followed
  by the group sum, and the arithmetic the backward kernels repeat;
- :func:`flash_bwd`: the backward wrapper.  It computes
  ``delta = rowsum(dO * O)`` with torch (:func:`bwd_delta`, as
  ``_flash_bwd_pallas`` does outside Pallas) and launches :func:`flash_bwd_dq` and
  :func:`flash_bwd_dkv`, each counting its launches in ``.launches``;
- :func:`flash_attention`: the public call with the JAX layout, q
  ``[B,H,S,D]`` and k, v ``[B,Hkv,Sk,D]`` (Hkv divides H).  It is a
  ``torch.autograd.Function`` whose forward saves ``(q, k, v, o, lse)``,
  as ``_flash_vjp_fwd`` does, and whose backward is :func:`flash_bwd`.

Causal masks are bottom-right aligned (the last query sees the last key),
the KV-cache decode convention; a row that sees no key gives output 0,
log-sum-exp ``+inf`` and gradient 0.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import builder

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
BLOCK = 64              # q-tile and key-tile rows of the plain versions
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
    dtype, as in the kernels, over 64-row tiles (the fp32 kernel's; the
    bf16 kernel's 128-key tiles round p against another running max, a
    difference within bf16's rounding).  Key tiles wholly past a q tile's
    causal diagonal are skipped: for every row that sees a key they would
    add exactly nothing (p = 0, alpha = 1)."""
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
    """Shapes, dtypes and devices every path takes; the head dims the
    kernels take are checked on the CUDA path only (:func:`_check_head_dim`),
    since the plain versions take any D."""
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
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: want all "
                        "bfloat16 or all float32")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"tensors on {q.device}, {k.device}, {v.device}")


def _check_head_dim(D: int) -> None:
    if D not in _HEAD_DIMS:
        raise ValueError(
            f"head dim {D}: the CUDA kernels take D in {_HEAD_DIMS} "
            "(ROADMAP B1d); CPU tensors of any D take the plain version")


class _BwdArgs(ctypes.Structure):
    """``BwdArgs`` of ``csrc/flash_bwd.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("q", "k", "v", "dout", "lse", "delta", "dq", "dk", "dv")] +
                [(n, ctypes.c_int) for n in
                 ("B", "H", "Hkv", "S", "Sk", "causal")] +
                [("scale", ctypes.c_float), ("pad", ctypes.c_int)] +
                [(n, ctypes.c_longlong * 3) for n in
                 ("qs", "ks", "vs", "dos", "dqs", "dks", "dvs")])


_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# library -> (entry point, its argtypes); every entry point returns int
_ENTRY = {
    "flash_fwd": ("dstpu_flash_fwd", [_PTR] * 5 + [_I32] * 7 + [_I64] * 12 +
                  [ctypes.c_float, _I32, _PTR]),
    "flash_bwd": ("dstpu_flash_bwd", [ctypes.POINTER(_BwdArgs), _I32, _I32,
                                      _I32, _PTR]),
}


def _lib(name: str) -> ctypes.CDLL:
    lib = builder.load(name)
    fn_name, argtypes = _ENTRY[name]
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, _I32
        lib.dstpu_cuda_error_string.argtypes = [_I32]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check_rows(**tensors: torch.Tensor) -> None:
    """The kernels read and write 16-byte rows: a contiguous head dim, a
    16-byte aligned base and strides that are multiples of 16 bytes."""
    for name, t in tensors.items():
        vec = 16 // t.element_size()
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                s % vec for s in t.stride()[:3]):
            raise ValueError(
                f"{name}: the kernel reads 16-byte rows; want a contiguous "
                f"head dim, a 16-byte aligned base and strides that are "
                f"multiples of {vec} (got strides {t.stride()})")


def _launch(q, k, v, causal: bool, sm_scale: float):
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    _check_head_dim(D)
    _check_rows(q=q, k=k, v=v)
    # o is laid out [B,S,H,D] and returned as its [B,H,S,D] view, so the
    # caller's transpose back to [B,S,H*D] costs no copy
    o = torch.empty(B, S, H, D, dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    lib = _lib("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dstpu_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _DTYPES[q.dtype], B, H, Hkv, S, Sk, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *o.stride()[:3], float(sm_scale), int(causal), stream)
    if err < 0:     # -(CUresult * 4 + which map): nothing was launched
        raise RuntimeError(
            f"flash_fwd: cuTensorMapEncodeTiled refused the tensor map of "
            f"{'qkvo'[-err % 4]} (CUresult {-err // 4}); TMA wants a 16-byte "
            f"aligned base and strides that are multiples of 16 bytes below "
            f"2^40 (strides q {q.stride()}, k {k.stride()}, v {v.stride()})")
    if err:
        raise RuntimeError("flash_fwd launch failed: " +
                           lib.dstpu_cuda_error_string(err).decode())
    return o, lse


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward: ``(out [B,H,S,D] in q's dtype, lse [B,H,S]
    fp32)``.  CPU tensors of any head dim take :func:`flash_fwd_reference`;
    CUDA tensors launch the kernel on the current stream (bf16 or fp32, D
    in {64, 128}, else it raises) and count the launch in
    ``flash_fwd.launches``."""
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


def flash_bwd_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blockwise backward in plain PyTorch: ``(dq, dk, dv)`` in the
    dtypes of q, k and v, with dk and dv summed over each KV head's group.

    P is recomputed from the saved ``lse`` (rows with ``lse = +inf`` get
    p = 0), ``dS = P * (dO V^T - delta)`` with ``delta = rowsum(dO * O)``,
    all in fp32 over 64-row q tiles.  P enters the dV product and dS the
    dQ and dK products rounded to the input dtype, as in the kernels."""
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dt = q.dtype
    qf = q.float().reshape(B, Hkv, G, S, D)
    dof = do.float().reshape(B, Hkv, G, S, D)
    lsef = lse.float().reshape(B, Hkv, G, S)
    delta = (dof * o.float().reshape(B, Hkv, G, S, D)).sum(-1)
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    offset = Sk - S
    kpos = torch.arange(Sk, device=q.device)
    dq = torch.empty(B, Hkv, G, S, D, dtype=torch.float32, device=q.device)
    dk = torch.zeros(B, Hkv, Sk, D, dtype=torch.float32, device=q.device)
    dv = torch.zeros(B, Hkv, Sk, D, dtype=torch.float32, device=q.device)
    for q0 in range(0, S, BLOCK):
        q1 = min(q0 + BLOCK, S)
        qb, dob = qf[..., q0:q1, :], dof[..., q0:q1, :]
        s = qb @ kf.transpose(-1, -2) * sm_scale       # [B,Hkv,G,bq,Sk]
        if causal:
            qpos = torch.arange(q0, q1, device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None] + offset,
                              DEFAULT_MASK_VALUE)
        p = torch.exp(s - lsef[..., q0:q1, None])
        dv += (p.to(dt).float().transpose(-1, -2) @ dob).sum(2)
        dp = dob @ vf.transpose(-1, -2)
        ds = (p * (dp - delta[..., q0:q1, None])).to(dt).float()
        dq[..., q0:q1, :] = (ds @ kf) * sm_scale
        dk += (ds.transpose(-1, -2) @ qb).sum(2)
    return (dq.reshape(B, H, S, D).to(dt), (dk * sm_scale).to(k.dtype),
            dv.to(v.dtype))


def _bwd_launch(which: int, q, k, v, do, lse, delta, causal, sm_scale):
    """Launch one backward kernel: 0 writes dq, 1 writes dk and dv.  The
    outputs are laid out [B,S,heads,D] and returned as [B,heads,S,D]
    views, the layout the projections' backward wants."""
    B, H, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    _check_head_dim(D)
    _check_rows(q=q, k=k, v=v, do=do)
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (B, H, S)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name}: want contiguous fp32 [B,H,S] on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    a = _BwdArgs(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                 dout=do.data_ptr(), lse=lse.data_ptr(),
                 delta=delta.data_ptr(), B=B, H=H, Hkv=Hkv, S=S, Sk=Sk,
                 causal=int(causal), scale=float(sm_scale))
    for field, t in (("qs", q), ("ks", k), ("vs", v), ("dos", do)):
        setattr(a, field, (ctypes.c_longlong * 3)(*t.stride()[:3]))
    if which == 0:
        outs = (torch.empty(B, S, H, D, dtype=q.dtype,
                            device=q.device).transpose(1, 2),)
        a.dq = outs[0].data_ptr()
        a.dqs = (ctypes.c_longlong * 3)(*outs[0].stride()[:3])
    else:
        outs = tuple(torch.empty(B, Sk, Hkv, D, dtype=t.dtype,
                                 device=q.device).transpose(1, 2)
                     for t in (k, v))
        a.dk, a.dv = outs[0].data_ptr(), outs[1].data_ptr()
        a.dks = (ctypes.c_longlong * 3)(*outs[0].stride()[:3])
        a.dvs = (ctypes.c_longlong * 3)(*outs[1].stride()[:3])
    lib = _lib("flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dstpu_flash_bwd(ctypes.byref(a), which, _DTYPES[q.dtype],
                                  D, stream)
    if err < 0:     # -(CUresult * 8 + which map): nothing was launched
        names = ("q", "k", "v", "dO", "dq" if which == 0 else "dk", "dv")
        raise RuntimeError(
            f"flash_bwd: cuTensorMapEncodeTiled refused the tensor map of "
            f"{names[-err % 8]} (CUresult {-err // 8}); TMA wants a "
            f"16-byte aligned base and strides that are multiples of 16 "
            f"bytes below 2^40")
    if err:
        raise RuntimeError("flash_bwd launch failed: " +
                           lib.dstpu_cuda_error_string(err).decode())
    return outs


def bwd_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in fp32, contiguous ``[B,H,S]``: a torch
    pass outside the kernels, as ``_flash_bwd_pallas`` computes it outside
    Pallas.  dO is copied to fp32 once and multiplied by O in place: one
    fp32 temporary instead of two (a copy even when dO is fp32 already,
    which ``.float()`` would return as it is, so the caller's dO is never
    written)."""
    return torch.sum(do.to(torch.float32, copy=True).mul_(o),
                     dim=-1).contiguous()


def _cuda_only(fn_name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{fn_name} launches a CUDA kernel; got a tensor "
                         f"on {q.device} (CPU callers use flash_bwd)")


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """dq [B,H,S,D] from the dQ kernel (CUDA tensors only); counts the
    launch in ``flash_bwd_dq.launches``."""
    _check(q, k, v)
    _cuda_only("flash_bwd_dq", q)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    (dq,) = _bwd_launch(0, q, k, v, do, lse, delta, causal, sm_scale)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                  sm_scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [B,Hkv,Sk,D], summed over each group, from the dK/dV
    kernel (CUDA tensors only); counts the launch in
    ``flash_bwd_dkv.launches``."""
    _check(q, k, v)
    _cuda_only("flash_bwd_dkv", q)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    dk, dv = _bwd_launch(1, q, k, v, do, lse, delta, causal, sm_scale)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention backward: ``(dq, dk, dv)`` in the dtypes and shapes of q,
    k and v.  CPU tensors take :func:`flash_bwd_reference`; CUDA tensors
    launch the dQ and dK/dV kernels.  ``dO`` whose rows the kernels cannot
    read as they are (a head dim that is not contiguous, strides or a base
    off 16 bytes) is copied to a contiguous tensor first."""
    _check(q, k, v)
    if do.shape != q.shape or do.dtype != q.dtype or o.shape != q.shape:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} and o "
                         f"{tuple(o.shape)} must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                   sm_scale=sm_scale)
    _cuda_only("flash_bwd", q)
    vec = 16 // do.element_size()
    if do.stride(3) != 1 or do.data_ptr() % 16 or any(
            s % vec for s in do.stride()[:3]):
        do = do.contiguous()
    delta = bwd_delta(do, o)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal, sm_scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal, sm_scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``_flash`` of the JAX package with its custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, lse = flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, causal=ctx.causal,
                               sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Flash attention.  q: [B, H, S, D]; k, v: [B, Hkv, Sk, D] where Hkv
    divides H (grouped-query attention).  Returns [B, H, S, D] in q.dtype,
    differentiable through :func:`flash_bwd`."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))
