"""The training step (``build_train_step``)."""
from paddle_tpu_torch.static.functionalize import TrainStep, build_train_step

__all__ = ["TrainStep", "build_train_step"]
