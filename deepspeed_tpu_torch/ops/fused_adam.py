"""Fused Adam/AdamW and Lion steps for the H100.

Counterpart of ``deepspeed_tpu/ops/fused_adam.py``.  The TPU kernels
``_adam_kernel`` and ``_lion_kernel`` become the hand-written CUDA kernels
of ``csrc/fused_adam.cu`` (see the note at its top): one launch per step
over flat fp32 buffers, which also applies ``p - lr * u`` (the JAX engine
does it right after the kernel) and writes the compute-dtype working copy
in the same pass.  Beside them, the plain PyTorch versions of the same
step, :func:`adam_update_reference` and :func:`lion_update_reference`.

Every function here updates its buffers in place (the port keeps one copy
of the optimizer state where JAX threads a new one through each step).
The step's scalars live in a small fp32 device tensor made by
:func:`step_scalars`, ``[lr, bc1, bc2, gscale, skip]``, so that nothing is
read on the host: ``gscale`` multiplies the gradient first (the engine's
``1/(loss scale * gas)`` and clipping factor), and a nonzero ``skip`` (the
fp16 overflow flag) leaves p, m, v and the working copy untouched.

CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise.  ``fused_adam.launches`` and ``fused_lion.launches`` count launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deepspeed_tpu_torch.ops import builder

_W_DTYPES = {None: 0, torch.bfloat16: 1, torch.float16: 2}


def step_scalars(device: torch.device) -> torch.Tensor:
    """A zeroed ``[lr, bc1, bc2, gscale, skip]`` fp32 tensor on
    ``device``, filled in place each step."""
    return torch.zeros(5, dtype=torch.float32, device=device)


def _write_copy(p: torch.Tensor, w: Optional[torch.Tensor],
                skip: torch.Tensor) -> None:
    if w is not None:
        w.copy_(torch.where(skip, w, p.to(w.dtype)))


def adam_update_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                          v: torch.Tensor, sc: torch.Tensor,
                          w: Optional[torch.Tensor] = None, *, b1: float,
                          b2: float, eps: float, wd: float,
                          adam_w: bool) -> None:
    """One Adam step in plain PyTorch, in place: the JAX package's
    ``adam_update_leaf`` (jnp branch) followed by ``p - lr * u``."""
    lr, bc1, bc2, gscale, skip = sc.unbind()
    skip = skip != 0
    gf = g.float() * gscale
    if wd and not adam_w:            # L2 mode: decay folded into the gradient
        gf = gf + wd * p
    m_new = b1 * m + (1.0 - b1) * gf
    v_new = b2 * v + (1.0 - b2) * gf * gf
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if wd and adam_w:                # decoupled (AdamW) decay
        u = u + wd * p
    p_new = p - lr * u
    m.copy_(torch.where(skip, m, m_new))
    v.copy_(torch.where(skip, v, v_new))
    p.copy_(torch.where(skip, p, p_new))
    _write_copy(p, w, skip)


def lion_update_reference(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                          sc: torch.Tensor,
                          w: Optional[torch.Tensor] = None, *, b1: float,
                          b2: float, wd: float) -> None:
    """One Lion step in plain PyTorch, in place: ``lion_update_leaf``
    (jnp branch) followed by ``p - lr * u``."""
    lr, _, _, gscale, skip = sc.unbind()
    skip = skip != 0
    gf = g.float() * gscale
    u = torch.sign(b1 * m + (1.0 - b1) * gf)
    if wd:
        u = u + wd * p
    p_new = p - lr * u
    m_new = b2 * m + (1.0 - b2) * gf
    m.copy_(torch.where(skip, m, m_new))
    p.copy_(torch.where(skip, p, p_new))
    _write_copy(p, w, skip)


def _lib() -> ctypes.CDLL:
    lib = builder.load("fused_adam")
    if lib.dstpu_fused_adam.argtypes is None:
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        lib.dstpu_fused_adam.argtypes = ([ptr] * 5 + [i32, ptr, i64] +
                                         [f32] * 6 + [i32, ptr])
        lib.dstpu_fused_adam.restype = i32
        lib.dstpu_fused_lion.argtypes = ([ptr] * 4 + [i32, ptr, i64] +
                                         [f32] * 5 + [ptr])
        lib.dstpu_fused_lion.restype = i32
        lib.dstpu_cuda_error_string.argtypes = [i32]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(p, w, sc, **state) -> None:
    n = p.numel()
    for name, t in dict(p=p, **state).items():
        if t.dtype != torch.float32 or t.numel() != n or \
                not t.is_contiguous() or t.device != p.device:
            raise ValueError(f"{name}: want a contiguous fp32 tensor of "
                             f"{n} elements on {p.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if w is not None and (w.dtype not in _W_DTYPES or w.numel() != n or
                          not w.is_contiguous() or w.device != p.device):
        raise ValueError(f"w: want a contiguous bf16 or fp16 tensor of {n} "
                         f"elements, got {w.dtype} {tuple(w.shape)}")
    if sc.dtype != torch.float32 or sc.shape != (5,) or sc.device != p.device:
        raise ValueError("sc: want the fp32 [5] tensor of step_scalars")


def _device_call(fn_name: str, p: torch.Tensor, *args) -> None:
    lib = _lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = getattr(lib, fn_name)(*args, stream)
    if err:
        raise RuntimeError(f"{fn_name} launch failed: " +
                           lib.dstpu_cuda_error_string(err).decode())


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def fused_adam(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               v: torch.Tensor, sc: torch.Tensor,
               w: Optional[torch.Tensor] = None, *, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8, wd: float = 0.0,
               adam_w: bool = True) -> None:
    """Adam step over flat fp32 ``p``, ``g``, ``m``, ``v`` in place, with
    the working copy ``w`` (bf16 or fp16, optional) written from the new
    ``p``.  CPU tensors take :func:`adam_update_reference`; CUDA tensors
    launch the kernel once."""
    _check(p, w, sc, g=g, m=m, v=v)
    kw = dict(b1=b1, b2=b2, eps=eps, wd=wd, adam_w=adam_w)
    if p.device.type == "cpu":
        return adam_update_reference(p, g, m, v, sc, w, **kw)
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam runs on cuda or cpu, not {p.device}")
    _device_call("dstpu_fused_adam", p, p.data_ptr(), g.data_ptr(),
                 m.data_ptr(), v.data_ptr(), _ptr(w),
                 _W_DTYPES[None if w is None else w.dtype], sc.data_ptr(),
                 p.numel(), b1, 1.0 - b1, b2, 1.0 - b2, eps, wd, int(adam_w))
    fused_adam.launches += 1


def fused_lion(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
               sc: torch.Tensor, w: Optional[torch.Tensor] = None, *,
               b1: float = 0.9, b2: float = 0.99, wd: float = 0.0) -> None:
    """Lion step over flat fp32 ``p``, ``g``, ``m`` in place (see
    :func:`fused_adam`)."""
    _check(p, w, sc, g=g, m=m)
    if p.device.type == "cpu":
        return lion_update_reference(p, g, m, sc, w, b1=b1, b2=b2, wd=wd)
    if p.device.type != "cuda":
        raise ValueError(f"fused_lion runs on cuda or cpu, not {p.device}")
    _device_call("dstpu_fused_lion", p, p.data_ptr(), g.data_ptr(),
                 m.data_ptr(), _ptr(w),
                 _W_DTYPES[None if w is None else w.dtype], sc.data_ptr(),
                 p.numel(), b1, 1.0 - b1, b2, 1.0 - b2, wd)
    fused_lion.launches += 1


fused_adam.launches = 0
fused_lion.launches = 0
