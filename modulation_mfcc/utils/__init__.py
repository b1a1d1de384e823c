"""Small shared utilities for the modulation-MFCC framework."""
from modulation_mfcc.utils.helpers import (
    cdiv,
    next_pow2,
    pad_center,
    round_up_to_multiple,
)

__all__ = ["cdiv", "next_pow2", "pad_center", "round_up_to_multiple"]
