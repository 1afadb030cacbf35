"""DeepSpeed-TPU's PyTorch port for NVIDIA Hopper (H100).

A second package beside the JAX reference ``deepspeed_tpu``: the same
names and module layout, plain tensor code in PyTorch, and every Pallas
TPU kernel on a ported path replaced by a CUDA kernel written for
``sm_90a``.  It imports neither JAX nor the reference package.  Entry
points run on the GPU unless the caller passes ``device="cpu"``.

Ported so far, on the Llama family: the v1 serving path,
``init_inference`` -> ``InferenceEngine.generate``; the ragged v2 serving
path, ``RaggedInferenceEngineV2`` over a paged KV pool; and training at
ZeRO stages 0-3 (with hpZ) over the data-parallel ranks of a
``torch.distributed`` process group (``deepspeed_tpu_torch.comm``), or in
one process, ``initialize`` -> ``engine.train_batch`` ->
``engine.save_checkpoint`` / ``engine.load_checkpoint``.
"""
from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
from deepspeed_tpu_torch.runtime.engine import initialize

__all__ = ["init_inference", "RaggedInferenceEngineV2", "initialize"]
