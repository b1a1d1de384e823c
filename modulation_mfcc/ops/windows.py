"""Window functions (host-side design, numpy).

Windows are *design-time constants*: they are computed once in float64 numpy
when a jitted feature function is traced, then closed over as literals in the
XLA program. Only the application (multiply) runs on the device.

The reference's MFCC path uses librosa's default Hann window
(reference: script/mfcc.py:387 — ``librosa.feature.mfcc`` with no ``window``
argument → ``scipy.signal.get_window('hann', win_length, fftbins=True)``).
"""
from __future__ import annotations

import numpy as np


def hann(m: int, periodic: bool = True) -> np.ndarray:
    """Periodic (fftbins=True) or symmetric Hann window, float64.

    Matches ``scipy.signal.get_window('hann', M, fftbins=periodic)``.
    """
    if m == 1:
        return np.ones(1)
    denom = m if periodic else m - 1
    n = np.arange(m)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / denom)


def hamming(m: int, periodic: bool = True) -> np.ndarray:
    """Hamming window matching scipy.signal.get_window('hamming', ...)."""
    if m == 1:
        return np.ones(1)
    denom = m if periodic else m - 1
    n = np.arange(m)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / denom)


def gaussian(m: int, std: float) -> np.ndarray:
    """Gaussian window, matches scipy.signal.windows.gaussian (symmetric)."""
    n = np.arange(m) - (m - 1) / 2.0
    return np.exp(-0.5 * (n / std) ** 2)


def praat_gauss(nw: int) -> np.ndarray:
    """Praat's AC_GAUSS / formant Gaussian taper (host-side f64):
    exp(−48·u²) with u = (i − imid)/(n+1), i = 1..n, edge-subtracted and
    normalized so the (virtual) endpoints hit exactly 0 — shared by the
    pitch tracker's veryAccurate window (Sound_to_Pitch.cpp) and the
    formant pre-window (Sound_to_Formant.cpp)."""
    i = np.arange(1, nw + 1, dtype=np.float64)
    imid = 0.5 * (nw + 1)
    edge = np.exp(-12.0)
    return (np.exp(-48.0 * ((i - imid) / (nw + 1)) ** 2) - edge) / (1.0 - edge)


def kaiser(m: int, beta: float, periodic: bool = False) -> np.ndarray:
    """Kaiser window via numpy (i0-based), symmetric by default."""
    if periodic:
        return np.kaiser(m + 1, beta)[:-1]
    return np.kaiser(m, beta)


_WINDOWS = {"hann": hann, "hamming": hamming}


def get_window(name: str, m: int, periodic: bool = True) -> np.ndarray:
    """Window by name; subset of scipy.signal.get_window used by the pipelines."""
    try:
        return _WINDOWS[name](m, periodic)
    except KeyError:
        raise ValueError(f"Unknown window {name!r}; available: {sorted(_WINDOWS)}")
