"""Amplitude envelope extraction (RMS / Hilbert / pitch-adaptive intensity).

Device-side rebuild of get_amplitude / calculate_amplitude_envelope
(reference: script/mfcc.py:137-259, duplicated at script/calc.py:221-343):

  * 'RMS'      — librosa.feature.rms semantics: centered framing with
                 constant padding, sqrt(mean(x²)) per frame — a framed
                 square-mean-sqrt fused reduction on device.
  * 'Hilb'     — |analytic signal| via device FFT.
  * 'RMSpraat' — Praat-style pitch-adaptive intensity: the effective window
                 is sized from an estimated minimum pitch (two-pass quantile
                 adaptation like the reference), then a Kaiser-windowed mean
                 square in dB; see ops/intensity.py.

Reference quirk preserved: the ``method != 'hilb'`` comparison at
script/mfcc.py:249 is case-sensitive, so even for method='Hilb' the returned
time axis is ``arange(len(amp)) * hopLen`` — we replicate that in
``envelope_times`` for parity (times are host-side).
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from modulation_mfcc.models.config import AmplitudeConfig
from modulation_mfcc.ops import filters as F
from modulation_mfcc.ops.framing import frame_signal, hop_window_sums
from modulation_mfcc.ops.hilbert import hilbert_envelope

__all__ = ["rms_envelope", "amplitude_envelope", "extract_envelope", "envelope_times"]


def rms_envelope(
    y: jnp.ndarray, frame_length: int, hop_length: int, *, center: bool = True
) -> jnp.ndarray:
    """librosa.feature.rms equivalent along the last axis → [..., n_frames].

    Every frame start is a multiple of ``hop_length`` (in padded
    coordinates), so the windowed energy decomposes into hop-row sums —
    x² is reshaped to [n_rows, hop] rows, each frame's energy is
    ``W//hop`` whole-row sums plus one ``W%hop`` row-prefix sum. That reads
    the signal once (O(T) device-memory traffic) instead of materializing
    the ``frame_length/hop``-times-larger gathered frame matrix. Falls back
    to gathered framing
    when the decomposition would unroll too many shifted adds.
    """
    W, H = int(frame_length), int(hop_length)
    if W // H > 64:
        frames = frame_signal(y, W, H, center=center)
        return jnp.sqrt(jnp.mean(frames * frames, axis=-1))
    n = y.shape[-1]
    pad = W // 2 if center else 0
    nf = 1 + (n + 2 * pad - W) // H
    if nf <= 0:
        raise ValueError(f"Signal of length {n} too short for frame_length={W}")
    # x² in padded coordinates; hop_window_sums zero-extends past the signal
    # end (never read by a valid frame: frame nf-1 ends inside the padding)
    cfg = [(0, 0)] * (y.ndim - 1) + [(pad, 0)]
    sq = jnp.pad(y, cfg) ** 2
    energy = hop_window_sums(sq, nf, W, H)
    return jnp.sqrt(energy / W)


def amplitude_envelope(
    y: jnp.ndarray, sr: float, cfg: AmplitudeConfig = AmplitudeConfig()
) -> jnp.ndarray:
    """Amplitude track per the reference's method switch (script/mfcc.py:200-247)."""
    if cfg.method == "Hilb":
        amp = hilbert_envelope(y)
        amp_sr = sr
    elif cfg.method == "RMS":
        fr_len = int(cfg.hopLen * sr)
        win_len = int(cfg.winLen * sr)
        amp = rms_envelope(y, win_len, fr_len, center=cfg.center)
        amp_sr = 1.0 / cfg.hopLen
    elif cfg.method == "RMSpraat":
        from modulation_mfcc.models.pitch_adaptive import praat_style_intensity

        amp, amp_sr = praat_style_intensity(y, sr, hop=cfg.hopLen)
    else:
        raise ValueError(f"Unknown amplitude method {cfg.method!r}")
    if cfg.outFilter is not None:
        amp = F.apply_filter(
            amp,
            amp_sr,
            filt=cfg.outFilter,
            cut_off=cfg.outFiltCutOff,
            filt_len=cfg.outFiltLen,
            filt_type=cfg.outFiltType,
            poly_ord=cfg.outFiltPolyOrd,
        )
    return amp


def envelope_times(n_samples: int, sr: float, cfg: AmplitudeConfig) -> np.ndarray:
    """Host-side time axis, preserving the reference's case-sensitivity quirk
    (script/mfcc.py:249: 'Hilb' != 'hilb' so ampT gets the hop grid... except
    the Hilb branch already produced a dense axis *of the same length*, so the
    published behavior is: dense grid scaled by hopLen for every non-praat
    method)."""
    if cfg.method == "Hilb":
        # reference computes arange(len(x))/sr first (mfcc.py:204), then
        # overwrites with arange(len(amp))*hopLen (mfcc.py:251); len(amp) ==
        # n_samples for Hilbert, so the effective axis is arange(n)*hopLen.
        return np.arange(n_samples) * cfg.hopLen
    if cfg.method == "RMS":
        fr_len = int(cfg.hopLen * sr)
        win_len = int(cfg.winLen * sr)
        nf = 1 + (n_samples + 2 * (win_len // 2) - win_len) // fr_len if cfg.center else 1 + (n_samples - win_len) // fr_len
        return np.arange(nf) * cfg.hopLen
    raise ValueError("RMSpraat times come from praat_style_intensity directly")


@partial(jax.jit, static_argnames=("cfg", "sr"))
def _amp_jit(y, sr, cfg):
    return amplitude_envelope(y, sr, cfg)


def extract_envelope(y, sr: float, cfg: AmplitudeConfig = AmplitudeConfig()):
    """(amplitude, times) — drop-in for the reference AmplitudeEnvelope source
    (script/main.py:840-851)."""
    y = jnp.asarray(y, dtype=jnp.float32)
    if cfg.method == "RMSpraat":
        from modulation_mfcc.models.pitch_adaptive import praat_style_intensity

        amp, amp_sr = praat_style_intensity(y, sr, hop=cfg.hopLen)
        t = np.arange(amp.shape[-1]) / amp_sr
        return amp, t
    amp = _amp_jit(y, float(sr), cfg)
    return amp, envelope_times(y.shape[-1], sr, cfg)
