"""Native async file I/O for the KV spill tiers (the JAX package's
``io/``; its sweep and tuner, ``io/bench.py``, are ROADMAP A12)."""
from deepspeed_tpu_torch.io.aio import aio_handle, aligned_empty

__all__ = ["aio_handle", "aligned_empty"]
