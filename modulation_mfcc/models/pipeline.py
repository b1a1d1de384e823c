"""Feature-pipeline composition — the reference's L2 layer, functionally.

The reference composes DataSource → Transformation → Plotter objects
(script/main.py:625-957 CurveGenerator). Here the same composition is a
registry of pure functions returning ``(times, values)`` plus an optional
derivation step (trajectory/velocity/acceleration). The GUI's per-curve
plotting is replaced by array outputs feeding viz/ or CSV export.

Reference parity notes:
  * derivations apply get_velocity with sr=1.0 — per-sample, not per-second
    (the reference's quirk at script/main.py:683/706); preserved here.
  * each source's hardcoded defaults match the corresponding
    DataSource.calculate (script/main.py:726-851).
"""
from __future__ import annotations

from typing import Callable

import numpy as np

import jax.numpy as jnp

from modulation_mfcc.models.config import (
    DerivationConfig,
    FormantConfig,
    PipelineConfig,
)

__all__ = [
    "extract_feature",
    "apply_derivation",
    "resolve_derivation",
    "FEATURES",
    "SECTION_OF_FEATURE",
]


def apply_derivation(
    t: np.ndarray, v: jnp.ndarray, derivation: int, dcfg: DerivationConfig = DerivationConfig()
):
    """0 = trajectory (identity), 1 = velocity, 2 = acceleration
    (script/main.py:653-712), with the reference's sr=1.0 convention."""
    if derivation == 0:
        return t, v
    from modulation_mfcc.ops.derivatives import velocity

    out = velocity(
        jnp.asarray(v),
        1.0,
        difference=derivation,
        method=dcfg.derivative_method,
        width=dcfg.sg_width,
        acc_order=dcfg.fin_diff_acc_order,
        poly_order=dcfg.sg_poly_order,
    )
    return t, out


def _mod_cepstr(path: str, cfg: PipelineConfig):
    from modulation_mfcc.io.wav import load_channel
    from modulation_mfcc.models.modulation import extract_mfcc_change

    y = load_channel(path, cfg.mfcc.signal_sample_rate, cfg.mfcc.channelN)
    v, t = extract_mfcc_change(y, cfg.mfcc)
    return t, v


def _mfcc_matrix(path: str, cfg: PipelineConfig):
    from modulation_mfcc.io.wav import load_channel
    from modulation_mfcc.models.modulation import extract_mfcc_matrix

    y = load_channel(path, cfg.mfcc.signal_sample_rate, cfg.mfcc.channelN)
    return extract_mfcc_matrix(y, cfg.mfcc)


def _envelope(path: str, cfg: PipelineConfig):
    from modulation_mfcc.io.wav import read_wav
    from modulation_mfcc.models.envelope import extract_envelope

    x, sr = read_wav(path)
    if x.ndim > 1:
        x = x[0]
    # reference quirk: its AmplitudeEnvelope source feeds *raw int16* sample
    # values to the RMS (scipy wavfile.read, script/main.py:844-848), so the
    # published curve is 2^15 times the normalized-amplitude RMS. Replicated
    # here so file-based values match the reference app exactly.
    amp, t = extract_envelope(x * 32768.0, sr, cfg.amplitude)
    return t, amp


def _f0(path: str, cfg: PipelineConfig):
    from modulation_mfcc.io.wav import read_wav
    from modulation_mfcc.models.pitch import extract_f0

    x, sr = read_wav(path)
    if x.ndim > 1:
        x = x[0]
    f0, t = extract_f0(x, sr, cfg.f0)
    return t, f0


def _formants_n(n: int):
    def fn(path: str, cfg: PipelineConfig):
        from modulation_mfcc.io.wav import read_wav
        from modulation_mfcc.models.formants import extract_formants

        x, sr = read_wav(path)
        if x.ndim > 1:
            x = x[0]
        fcfg: FormantConfig = getattr(cfg, f"formant{n}")
        t, f = extract_formants(x, sr, fcfg)
        return t, f[n - 1]

    return fn


def _soundwave(path: str, cfg: PipelineConfig):
    from modulation_mfcc.io.wav import read_wav

    x, sr = read_wav(path)
    if x.ndim > 1:
        x = x[0]
    return np.arange(len(x)) / sr, x


FEATURES: dict[str, Callable] = {
    "mod_cepstr": _mod_cepstr,
    "mfcc": _mfcc_matrix,
    "envelope": _envelope,
    "f0": _f0,
    "formant1": _formants_n(1),
    "formant2": _formants_n(2),
    "formant3": _formants_n(3),
    "soundwave": _soundwave,
}

#: which config section supplies each feature's dialog metadata (derivation
#: settings etc.); None = no configurable derivation row in the reference.
SECTION_OF_FEATURE: dict[str, str | None] = {
    "mod_cepstr": "mfcc",
    "mfcc": "mfcc",
    "envelope": "amplitude",
    "f0": "f0",
    "formant1": "formant1",
    "formant2": "formant2",
    "formant3": "formant3",
    "soundwave": None,
    "ema": "ema",
    "custom": None,
}


def resolve_derivation(
    feature: str,
    cfg: PipelineConfig,
    derivation: int | None,
    dcfg: DerivationConfig | None,
) -> tuple[int, DerivationConfig]:
    """Fill unset derivation arguments from the feature's config section —
    a JSON saved with e.g. "F0 velocity, sg" must actually produce the
    derived curve (reference config_dialog.py:692-725)."""
    section = SECTION_OF_FEATURE.get(feature)
    meta = cfg.meta_for(section) if section else None
    if dcfg is None:
        dcfg = meta.derivation if meta else DerivationConfig()
    if derivation is None:
        derivation = dcfg.derivation_type
    return derivation, dcfg


def extract_feature(
    path: str,
    feature: str,
    cfg: PipelineConfig = PipelineConfig(),
    *,
    derivation: int | None = None,
    dcfg: DerivationConfig | None = None,
):
    """(times, values) for a named feature of one audio file — the functional
    CurveGenerator.generate (script/main.py:929-957).

    ``derivation``/``dcfg`` default to the feature's section settings in
    ``cfg`` (the saved dialog state); pass them explicitly to override.
    """
    try:
        src = FEATURES[feature]
    except KeyError:
        raise ValueError(f"Unknown feature {feature!r}; available: {sorted(FEATURES)}")
    derivation, dcfg = resolve_derivation(feature, cfg, derivation, dcfg)
    t, v = src(path, cfg)
    return apply_derivation(t, v, derivation, dcfg)
