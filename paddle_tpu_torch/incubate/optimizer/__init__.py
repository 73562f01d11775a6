"""incubate.optimizer: ``GradientMergeOptimizer``."""
from paddle_tpu_torch.incubate.optimizer.gradient_merge import (
    GradientMergeOptimizer,
)

__all__ = ["GradientMergeOptimizer"]
