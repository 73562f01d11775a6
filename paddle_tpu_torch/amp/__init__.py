"""Mixed precision: ``auto_cast`` with the reference's op lists (O0, OD,
O1, O2), ``decorate`` and ``GradScaler`` (``paddle_tpu/amp``)."""
from paddle_tpu_torch.amp.auto_cast import (
    BLACK_LIST, WHITE_LIST, amp_guard, auto_cast, black_list, decorate,
    is_auto_cast_enabled, white_list,
)
from paddle_tpu_torch.amp.grad_scaler import AmpScaler, GradScaler

__all__ = ["AmpScaler", "BLACK_LIST", "GradScaler", "WHITE_LIST",
           "amp_guard", "auto_cast", "black_list", "decorate",
           "is_auto_cast_enabled", "is_bfloat16_supported",
           "is_float16_supported", "white_list"]


def is_float16_supported(device=None):
    """float16 runs on the card and on the CPU (the reference's answer:
    always)."""
    return True


def is_bfloat16_supported(device=None):
    return True
