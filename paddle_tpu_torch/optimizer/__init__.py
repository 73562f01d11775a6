"""Optimizers with the reference's functional update, their learning-rate
schedulers (``lr``) and the eager API (``paddle_tpu/optimizer``)."""
from paddle_tpu_torch.optimizer import lr
from paddle_tpu_torch.optimizer.optimizer import Optimizer
from paddle_tpu_torch.optimizer.optimizers import (
    ASGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Momentum, NAdam,
    RAdam, RMSProp, Rprop, SGD,
)

__all__ = ["ASGD", "Adadelta", "Adagrad", "Adam", "AdamW", "Adamax",
           "Lamb", "Momentum", "NAdam", "Optimizer", "RAdam", "RMSProp",
           "Rprop", "SGD", "lr"]
