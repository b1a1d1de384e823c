"""Shape/padding helpers used across ops and kernels."""
from __future__ import annotations

import numpy as np


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def round_up_to_multiple(x: int, m: int) -> int:
    """Round ``x`` up to the nearest multiple of ``m`` (bucket and tile alignment)."""
    return ((x + m - 1) // m) * m


def next_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    p = 1
    while p < n:
        p *= 2
    return p


def pad_center(data: np.ndarray, size: int, axis: int = -1) -> np.ndarray:
    """Center-pad a 1-D window to ``size`` samples with zeros.

    Mirrors librosa.util.pad_center, which the reference relies on implicitly
    when its 250-sample analysis window is placed inside a 512-point FFT
    (reference: script/mfcc.py:382-387).
    """
    n = data.shape[axis]
    lpad = (size - n) // 2
    lengths = [(0, 0)] * data.ndim
    lengths[axis] = (lpad, size - n - lpad)
    if lpad < 0:
        raise ValueError(f"Target size {size} < input size {n}")
    return np.pad(data, lengths, mode="constant")
