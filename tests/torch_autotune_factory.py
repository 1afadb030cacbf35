"""The tiny Llama training job the port's autotuning tests measure: an
import path for ``make_subprocess_runner`` (``torch_autotune_factory:
tiny_llama``), which a fresh interpreter imports with this directory on
``PYTHONPATH``.  It imports nothing of JAX."""
import numpy as np
import torch

from deepspeed_tpu_torch.models import llama

TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
SEQ = 16


def tiny_model():
    """The loss module on the meta device: the engine draws its weights."""
    with torch.device("meta"):
        return llama.LlamaLMLoss(llama.LlamaConfig(**TINY,
                                                   dtype=torch.float32))


def batch_fn(n):
    return np.random.default_rng(0).integers(0, TINY["vocab_size"],
                                             size=(max(n, 1), SEQ))


def tiny_llama():
    torch.set_num_threads(1)
    return tiny_model(), batch_fn
