from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    online_softmax_attention,
    ref_attention,
)

__all__ = ["flash_attention", "online_softmax_attention", "ref_attention"]
