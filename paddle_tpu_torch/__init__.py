"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu.

A second package beside ``paddle_tpu/`` (the JAX reference, unchanged).
It imports ``torch`` and never ``jax`` or anything of ``paddle_tpu``; it
keeps its own copy of what it needs.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; every TPU kernel on a ported
path is replaced by a hand-written Hopper kernel (``ops/csrc/``) built
with ``nvcc`` at first use, never at import.

Ported so far: the Llama serving path (the paged / dense KV decode and
chunked-prefill attention, K8 and K9, the step-wise decode functions,
the KV cache managers and the continuous-batching ``ServingEngine``,
float and int8); the Llama training step (flash attention K1-K5, fused
RoPE K6, the int8-moment AdamW K7); and BERT/ERNIE masked-LM training
(``models/bert.py``) with padding and varlen masks on the segment-masked
flash kernels.
"""
from paddle_tpu_torch.core.device import resolve_device

__all__ = ["resolve_device"]
