"""Functionals of the port: norms with their custom backwards,
activations, dropout and the attention routing."""
from paddle_tpu_torch.nn.functional.activation import gelu, tanh
from paddle_tpu_torch.nn.functional.attention import (
    flash_attention, flash_attn_unpadded, scaled_dot_product_attention,
)
from paddle_tpu_torch.nn.functional.common import dropout
from paddle_tpu_torch.nn.functional.norm import layer_norm, rms_norm

__all__ = ["dropout", "flash_attention", "flash_attn_unpadded", "gelu",
           "layer_norm", "rms_norm", "scaled_dot_product_attention", "tanh"]
