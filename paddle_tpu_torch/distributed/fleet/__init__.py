"""fleet: activation recompute."""
from paddle_tpu_torch.distributed.fleet.recompute import recompute

__all__ = ["recompute"]
