"""Ragged continuous-batching serving (v2) over a paged KV pool."""
from deepspeed_tpu_torch.inference.v2.ragged_engine import (
    RaggedInferenceEngineV2, Request)

__all__ = ["RaggedInferenceEngineV2", "Request"]
