"""Pitch-adaptive ('RMSpraat') intensity envelope.

Reference flow (script/mfcc.py:208-240): estimate pitch with a wide range
(50-700 Hz), take the 25/75 % quantiles of voiced frames, re-estimate with
[0.75·q25, 2.5·q75], then compute Praat intensity with a window sized by the
minimum of the raw second-pass track (unvoiced frames count as 0 Hz) — or,
if that minimum is ≤ 120 Hz (i.e. whenever any frame is unvoiced), with
minPitch=120 at sample-rate time resolution.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from modulation_mfcc.ops.intensity import intensity_db
from modulation_mfcc.ops.pitch import pitch_ac

__all__ = ["praat_style_intensity"]


def praat_style_intensity(x: jnp.ndarray, sr: float, *, hop: float = 0.01):
    """(intensity_db [NF], rate_hz) following the reference's two-pass logic."""
    x = jnp.asarray(x, dtype=jnp.float32)
    f0 = np.asarray(pitch_ac(x, sr=float(sr), hop=hop, min_pitch=50.0, max_pitch=700.0))
    voiced = f0[f0 > 20]
    if voiced.size:
        q = np.quantile(voiced, [0.25, 0.75])
        lo, hi = 0.75 * float(q[0]), 2.5 * float(q[1])
        if hi > lo > 0:
            f0 = np.asarray(
                pitch_ac(x, sr=float(sr), hop=hop, min_pitch=lo, max_pitch=hi)
            )
    # Reference (script/mfcc.py:227) takes np.min over the RAW second-pass
    # track — unvoiced frames are 0 Hz, so any unvoiced frame forces the
    # (120, 1/sr) dense-intensity branch. Do NOT restrict to voiced frames.
    min_obs = float(f0.min()) if f0.size else 0.0
    if min_obs > 120.0:
        amp = intensity_db(x, sr=float(sr), min_pitch=min_obs, time_step=hop)
        rate = 1.0 / hop
    else:
        amp = intensity_db(x, sr=float(sr), min_pitch=120.0, time_step=1.0 / float(sr))
        rate = float(sr)
    return amp, rate
