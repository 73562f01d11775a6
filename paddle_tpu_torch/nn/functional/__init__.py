"""RMSNorm with its custom backward and the attention routing."""
from paddle_tpu_torch.nn.functional.attention import (
    scaled_dot_product_attention,
)
from paddle_tpu_torch.nn.functional.norm import rms_norm

__all__ = ["rms_norm", "scaled_dot_product_attention"]
