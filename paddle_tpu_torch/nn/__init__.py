"""Neural-network functionals (``nn.functional``), the layers of the BERT
encoder (``nn.layer``) and gradient clipping (``nn.clip``)."""
from paddle_tpu_torch.nn.clip import (
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue,
    GradientClipByGlobalNorm, GradientClipByNorm, GradientClipByValue,
    clip_grad_norm_, clip_grad_value_,
)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "GradientClipByGlobalNorm", "GradientClipByNorm",
           "GradientClipByValue", "clip_grad_norm_", "clip_grad_value_"]
