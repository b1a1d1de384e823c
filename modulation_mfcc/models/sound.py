"""Sound + spectrogram adapters (the reference's parselmouth layer).

Replaces script/praat_py_ui/parselmouth_calc.py:6-39: WAV → ``Sound``
(timestamps + amplitudes) and a Praat-style wideband spectrogram in dB
(``10*log10`` of the power matrix, Gaussian analysis window). Praat's
``to_spectrogram`` defaults: 5 ms effective window (physical window twice
that, Gaussian taper), 5 kHz view ceiling, 2 ms time step.

The spectrogram is computed with the framework's own device-side framed rFFT
(one jitted call), not a per-column loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from modulation_mfcc.io.wav import read_wav
from modulation_mfcc.ops.framing import frame_by_slices
from modulation_mfcc.ops.windows import gaussian

__all__ = ["Sound", "Spectrogram", "load_sound", "praat_spectrogram"]


@dataclass
class Sound:
    timestamps: np.ndarray
    amplitudes: np.ndarray  # [channels, n]
    sample_rate: float


@dataclass
class Spectrogram:
    timestamps: np.ndarray
    frequencies: np.ndarray
    data_matrix: np.ndarray  # dB, [n_freqs, n_times]


def load_sound(path: str) -> Sound:
    """WAV → Sound (reference Parselmouth.get_sound semantics)."""
    x, sr = read_wav(path)
    if x.ndim == 1:
        x = x[None, :]
    n = x.shape[-1]
    return Sound(np.arange(n) / sr, x, float(sr))


@partial(jax.jit, static_argnames=("sr", "nw", "hop", "n_fft"))
def _spec_power(x, sr, nw, hop, n_fft):
    nf = 1 + (x.shape[-1] - nw) // hop
    frames = frame_by_slices(x, 0, nf, nw, hop)
    frames = frames - jnp.mean(frames, axis=-1, keepdims=True)
    w = jnp.asarray(gaussian(nw, nw / 6.0), dtype=x.dtype)
    spec = jnp.fft.rfft(frames * w, n=n_fft, axis=-1)
    return jnp.real(spec) ** 2 + jnp.imag(spec) ** 2


def praat_spectrogram(
    x: np.ndarray,
    sr: float,
    *,
    window_length: float = 0.005,
    max_frequency: float = 5000.0,
    time_step: float = 0.002,
    zoom_blur: bool = False,
) -> Spectrogram:
    """Wideband dB spectrogram with Praat-flavored defaults
    (reference parselmouth_calc.py:31-39: to_spectrogram + 10*log10).

    ``zoom_blur`` reproduces the reference display's optional smoothing
    (praat_py_ui/spectrogram.py:70-71): the dB matrix is upsampled 6× with
    an order-4 spline (scipy.ndimage.zoom) before display; the time and
    frequency axes are re-gridded to match (the reference scales its image
    rect, which is the same mapping)."""
    x = np.asarray(x, dtype=np.float32)
    if x.ndim > 1:
        x = x[0]
    nw = max(8, int(round(2 * window_length * sr)))
    hop = max(1, int(round(time_step * sr)))
    n_fft = 1
    while n_fft < nw:
        n_fft *= 2
    p = np.asarray(_spec_power(jnp.asarray(x), float(sr), nw, hop, n_fft))
    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    keep = freqs <= max_frequency
    db = 10.0 * np.log10(np.maximum(p[:, keep], 1e-12))
    times = (np.arange(p.shape[0]) * hop + nw / 2) / sr
    fkept = freqs[keep]
    if zoom_blur:
        from scipy.ndimage import zoom as nd_zoom

        mat = nd_zoom(db.T, 6, order=4)  # [freq*6, time*6]
        fkept = np.linspace(fkept[0], fkept[-1], mat.shape[0])
        times = np.linspace(times[0], times[-1], mat.shape[1])
        return Spectrogram(times, fkept, mat)
    return Spectrogram(times, fkept, db.T)
