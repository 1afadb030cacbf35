"""The port's model families: Llama (``llama``), GPT-2 (``gpt2``) and the
sparse-MoE families Mixtral (``mixtral``) and Qwen2-MoE (``qwen2_moe``).
``PRESETS`` maps each family to its named configurations."""
from deepspeed_tpu_torch.models import gpt2, llama, mixtral, qwen2_moe
from deepspeed_tpu_torch.models.mixtral import (MixtralConfig,
                                                MixtralForCausalLM)
from deepspeed_tpu_torch.models.qwen2_moe import (Qwen2MoeConfig,
                                                  Qwen2MoeForCausalLM)

PRESETS = {"llama": llama.PRESETS, "gpt2": gpt2.PRESETS,
           "mixtral": mixtral.PRESETS, "qwen2_moe": qwen2_moe.PRESETS}

__all__ = ["gpt2", "llama", "mixtral", "qwen2_moe", "MixtralConfig",
           "MixtralForCausalLM", "Qwen2MoeConfig", "Qwen2MoeForCausalLM",
           "PRESETS"]
