"""Accelerator abstraction: ``get_accelerator()`` and ``resolve_device()``.

Counterpart of ``deepspeed_tpu/accelerator.py`` (the reference's
``accelerator/real_accelerator.py:52 get_accelerator``) on CUDA.  The
TPU version has no streams or events because XLA owns scheduling; here
they are PyTorch's CUDA streams and events, and ``manual_seed`` returns a
seeded ``torch.Generator`` where the TPU version returned a PRNG key.

The port runs on the GPU.  :func:`resolve_device` is how every entry point
picks its device: ``cuda`` unless the caller names another device
explicitly, and an error, never a silent CPU run, when there is no GPU.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Optional, Union

import torch
import torch.distributed as dist

DeviceLike = Union[None, str, int, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device and raises when no GPU is
    present; the CPU is used only when the caller asks for it
    (``device="cpu"``, as the tests do).  Under an initialised process
    group, ``cuda`` without an index is ``cuda:LOCAL_RANK`` (one GPU per
    rank, as ``torchrun`` sets it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA GPU is available; the port runs on the GPU unless "
                "the caller passes device='cpu'")
        if dev.index is None:
            index = torch.cuda.current_device()
            if dist.is_available() and dist.is_initialized() and \
                    "LOCAL_RANK" in os.environ:
                index = int(os.environ["LOCAL_RANK"])
            dev = torch.device("cuda", index)
    return dev


class CUDA_Accelerator:
    """The CUDA device of this process."""

    # -- identity -------------------------------------------------------

    def device_name(self, device_index: Optional[int] = None) -> str:
        return "cuda" if device_index is None else f"cuda:{device_index}"

    def current_device_name(self) -> str:
        return self.device_name(self.current_device())

    def current_device(self) -> int:
        return torch.cuda.current_device()

    def device_count(self) -> int:
        return torch.cuda.device_count()

    def is_available(self) -> bool:
        return torch.cuda.is_available()

    def communication_backend_name(self) -> str:
        return "nccl"

    def device_kind(self) -> str:
        return torch.cuda.get_device_name(self.current_device())

    # -- capabilities ---------------------------------------------------

    def is_bf16_supported(self) -> bool:
        return torch.cuda.is_bf16_supported()

    def is_fp16_supported(self) -> bool:
        return True

    def is_triton_supported(self) -> bool:
        return importlib.util.find_spec("triton") is not None

    # -- memory ---------------------------------------------------------

    def total_memory(self, device_index: Optional[int] = None) -> int:
        return torch.cuda.get_device_properties(
            self._index(device_index)).total_memory

    def memory_allocated(self, device_index: Optional[int] = None) -> int:
        return torch.cuda.memory_allocated(self._index(device_index))

    def max_memory_allocated(self, device_index: Optional[int] = None
                             ) -> int:
        return torch.cuda.max_memory_allocated(self._index(device_index))

    def reset_peak_memory_stats(self, device_index: Optional[int] = None
                                ) -> None:
        torch.cuda.reset_peak_memory_stats(self._index(device_index))

    def available_memory(self, device_index: Optional[int] = None) -> int:
        return torch.cuda.mem_get_info(self._index(device_index))[0]

    def empty_cache(self) -> None:
        torch.cuda.empty_cache()

    # -- execution ------------------------------------------------------

    def synchronize(self, device_index: Optional[int] = None) -> None:
        torch.cuda.synchronize(self._index(device_index))

    def Stream(self, **kwargs) -> torch.cuda.Stream:
        return torch.cuda.Stream(**kwargs)

    def Event(self, **kwargs) -> torch.cuda.Event:
        return torch.cuda.Event(**kwargs)

    def current_stream(self, device_index: Optional[int] = None
                       ) -> torch.cuda.Stream:
        return torch.cuda.current_stream(self._index(device_index))

    def stream(self, stream: torch.cuda.Stream):
        return torch.cuda.stream(stream)

    def manual_seed(self, seed: int) -> torch.Generator:
        """A generator on the current device, seeded: pass it explicitly."""
        return torch.Generator(device=self.current_device_name()
                               ).manual_seed(seed)

    def manual_seed_all(self, seed: int) -> None:
        torch.cuda.manual_seed_all(seed)

    # -- dtypes ---------------------------------------------------------

    def supported_dtypes(self):
        return [torch.float32, torch.bfloat16, torch.float16]

    # -- misc parity ----------------------------------------------------

    def on_accelerator(self, x) -> bool:
        return isinstance(x, torch.Tensor) and x.is_cuda

    def pin_memory(self, x: torch.Tensor) -> torch.Tensor:
        return x.pin_memory()

    def lazy_call(self, fn):
        return fn()

    def _index(self, device_index: Optional[int]) -> int:
        return self.current_device() if device_index is None else device_index


_ACCELERATOR: Optional[CUDA_Accelerator] = None


def get_accelerator() -> CUDA_Accelerator:
    """Reference ``get_accelerator()`` entry point."""
    global _ACCELERATOR
    if _ACCELERATOR is None:
        _ACCELERATOR = CUDA_Accelerator()
    return _ACCELERATOR
