"""The port's serving engine (one replica) and its fault-injection plan."""
from paddle_tpu_torch.serving.engine import (
    AcceptWindow, EngineOverloaded, KVPoolExhausted, Request, ServingEngine,
    SpecConfig,
)
from paddle_tpu_torch.serving.faults import (
    FaultPlan, InjectedDispatchError, InjectedStreamCbError,
)

__all__ = ["AcceptWindow", "EngineOverloaded", "FaultPlan",
           "InjectedDispatchError", "InjectedStreamCbError",
           "KVPoolExhausted", "Request", "ServingEngine", "SpecConfig"]
