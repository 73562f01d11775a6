"""The port's serving engine (one replica)."""
from paddle_tpu_torch.serving.engine import (
    AcceptWindow, KVPoolExhausted, Request, ServingEngine, SpecConfig,
)

__all__ = ["AcceptWindow", "KVPoolExhausted", "Request", "ServingEngine",
           "SpecConfig"]
