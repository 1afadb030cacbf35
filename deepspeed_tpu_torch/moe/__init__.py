from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.moe.sharded_moe import (moe_combine, moe_dispatch,
                                                 top1gating, top2gating,
                                                 topkgating)

__all__ = ["MoE", "top1gating", "top2gating", "topkgating", "moe_combine",
           "moe_dispatch"]
