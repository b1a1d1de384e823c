"""Formant tracking pipeline — the reference's calc_formants surface.

Mirrors script/calc.py:131-170: Burg LPC formants (Praat conventions:
resample to 2× ceiling, 50 Hz pre-emphasis, Gaussian window of twice the
nominal length, order = 2×max_number_of_formants), sample F1–F3 at frame
times, gate frames whose intensity is below ``energy_threshold`` dB
(sound.to_intensity() with Praat defaults: minPitch=100, timeStep auto =
0.8/minPitch).
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from modulation_mfcc.models.config import FormantConfig
from modulation_mfcc.io.wav import resample
from modulation_mfcc.ops.intensity import intensity_db, intensity_times
from modulation_mfcc.ops.lpc import formant_frames, lpc_formants

__all__ = ["extract_formants", "formants_with_gating"]


def extract_formants(x, sr: float, cfg: FormantConfig = FormantConfig()):
    """(times, [f1, f2, f3]) gated by intensity — reference calc_formants
    output shape (script/calc.py:164-170). Gated-out frames are dropped
    (host-side boolean indexing, like the reference's dict filtering)."""
    t, f123, keep = formants_with_gating(x, sr, cfg)
    return t[keep], [f123[0][keep], f123[1][keep], f123[2][keep]]


def formants_with_gating(x, sr: float, cfg: FormantConfig = FormantConfig()):
    """Device formant tracks + host gating mask.

    Returns (times [NF], f123 [3][NF], keep [NF] bool). The static-shape
    device part computes every frame; the variable-length selection is a
    host-side mask (the only inherently ragged step)."""
    x = np.asarray(x, dtype=np.float64)
    target_sr = 2.0 * cfg.max_formant
    xr = resample(x, sr, target_sr)
    order = 2 * cfg.max_num_formants
    freqs, _bw = lpc_formants(
        jnp.asarray(xr, dtype=jnp.float32),
        sr=float(target_sr),
        order=order,
        window_length=cfg.window_length,
        time_step=cfg.time_step,
        pre_emphasis_from=cfg.pre_emphasis_from,
        max_formant=cfg.max_formant,
    )
    freqs = np.asarray(freqs)
    _, _, times = formant_frames(
        len(xr), target_sr, cfg.window_length, cfg.time_step
    )
    # intensity gating at formant frame times (Praat to_intensity defaults:
    # minPitch 100, timeStep auto = 0.8/minPitch — calc.py:156)
    min_pitch = 100.0
    tstep = 0.0
    db = np.asarray(
        intensity_db(
            jnp.asarray(x, dtype=jnp.float32), sr=float(sr), min_pitch=min_pitch, time_step=tstep
        )
    )
    tdb = intensity_times(len(x), sr, min_pitch, tstep)
    at_frames = np.interp(times, tdb, db)
    keep = at_frames > cfg.energy_threshold
    f123 = [freqs[:, 0], freqs[:, 1], freqs[:, 2]]
    return times, f123, keep
