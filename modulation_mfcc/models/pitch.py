"""F0 extraction pipeline — the reference's get_f0 surface.

Mirrors script/calc.py:386-592: method praatac/praatcc (ops/pitch.py
autocorrelation + Viterbi) or pyin (ops/yin.py), optional two-pass
quantile-adaptive pitch range (minMaxQuant), unvoiced→NaN, NaN
interpolation, optional zero-phase post filter.

Static-shape note: the pitch floor/ceiling determine window lengths, so they
are *static* arguments — the minMaxQuant second pass pulls the quantiles to
the host, rounds them to 0.1 Hz (bounding the number of distinct compiled
programs) and re-traces once per distinct rounded range.
"""
from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from modulation_mfcc.models.config import F0Config
from modulation_mfcc.ops import filters as F
from modulation_mfcc.ops.interp import interp_nan
from modulation_mfcc.ops.pitch import pitch_ac

__all__ = ["extract_f0"]


def _raw_f0(
    x: jnp.ndarray,
    sr: float,
    cfg: F0Config,
    min_pitch: float,
    max_pitch: float,
    method: str | None = None,
):
    method = method or cfg.method
    if method in ("praatac", "praatcc"):
        return pitch_ac(
            x,
            sr=float(sr),
            hop=cfg.hopSize,
            min_pitch=float(min_pitch),
            max_pitch=float(max_pitch),
            max_cand=cfg.maxCandNum,
            method="ac" if method == "praatac" else "cc",
            silence_thresh=cfg.silenceThresh,
            voicing_thresh=cfg.voicingThresh,
            octave_cost=cfg.octaveCost,
            octave_jump_cost=cfg.octaveJumpCost,
            voiced_unvoiced_cost=cfg.voicedUnvoicedCost,
            very_accurate=bool(cfg.veryAccurate),
        )
    if method == "pyin":
        from modulation_mfcc.ops.yin import pyin_f0

        return pyin_f0(
            x,
            sr=float(sr),
            fmin=float(min_pitch),
            fmax=float(max_pitch),
            frame_length=cfg.pyinframe_length,
            win_length=cfg.pyinwin_length,
            hop=cfg.hopSize,
            n_thresholds=cfg.n_thresholds,
            beta_parameters=cfg.beta_parameters,
            boltzmann_parameter=cfg.boltzmann_parameter,
            resolution=cfg.resolution,
            max_transition_rate=cfg.max_transition_rate,
            switch_prob=cfg.switch_prob,
            no_trough_prob=cfg.no_trough_prob,
            center=cfg.pyincenter,
            pad_mode=cfg.pyinpad_mode,
        )
    raise ValueError(f"Unknown f0 method {method!r}")


def extract_f0(x, sr: float, cfg: F0Config = F0Config()):
    """(f0, times) with the reference's post-processing chain.

    Validation parity: filtering requires interpolated unvoiced regions
    (script/calc.py:530-533).
    """
    if cfg.interpUnvoiced is None and cfg.outFilter is not None:
        raise ValueError(
            "Post processing filters should be applied (outFilter is not "
            "None) but unvoiced regions are not interpolated (interpUnvoiced "
            "is None). Cannot filter f0 signal with gaps due to unvoiced regions"
        )
    x = jnp.asarray(x, dtype=jnp.float32)
    min_pitch, max_pitch = cfg.minPitch, cfg.maxPitch
    f0 = _raw_f0(x, sr, cfg, min_pitch, max_pitch)
    if cfg.minMaxQuant is not None:
        v = np.asarray(f0)
        # reference quirks: praat filters the first pass by >20 Hz and the
        # second pass is ALWAYS "To Pitch (ac)" even for method='praatcc'
        # (script/calc.py:548-556); pyin filters by non-NaN and re-runs pyin
        # (script/calc.py:571-581)
        v = v[~np.isnan(v)] if cfg.method == "pyin" else v[v > 20]
        if v.size:
            q = np.quantile(v, [cfg.minMaxQuant[0], cfg.minMaxQuant[1]])
            lo, hi = round(float(q[0]), 1), round(float(q[1]), 1)
            if hi > lo > 0:
                second = "pyin" if cfg.method == "pyin" else "praatac"
                f0 = _raw_f0(x, sr, cfg, lo, hi, method=second)
    f0 = np.asarray(f0, dtype=np.float64)
    if cfg.method == "pyin":
        # pyin marks unvoiced with fill_na (default NaN, script/calc.py:417)
        fill = np.nan if cfg.pyinfill_na is None else float(cfg.pyinfill_na)
        f0[f0 <= 0] = fill
    else:
        f0[f0 <= 20] = np.nan  # unvoiced → NaN (script/calc.py:559)
    f0t = np.arange(len(f0)) * cfg.hopSize
    if cfg.interpUnvoiced is not None:
        if np.all(np.isnan(f0)):
            return f0, f0t  # fully unvoiced: nothing to interpolate
        f0 = np.asarray(interp_nan(jnp.asarray(f0), cfg.interpUnvoiced))
    if cfg.outFilter is not None:
        f0 = np.asarray(
            F.apply_filter(
                jnp.asarray(f0),
                1.0 / cfg.hopSize,
                filt=cfg.outFilter,
                cut_off=cfg.outFiltCutOff,
                filt_len=cfg.outFiltLen,
                filt_type=cfg.outFiltType,
                poly_ord=cfg.outFiltPolyOrd,
            )
        )
    return f0, f0t
