"""Direct Praat cross-checks — run only where praat-parselmouth is installed.

This environment cannot install parselmouth (SURVEY.md §4: tolerance-based
parity for the Praat-derived kernels is validated behaviorally on synthetic
ground truth instead). Users with Praat available get the direct comparison
by running this module; CI skips it cleanly.
"""
import numpy as np
import pytest

parselmouth = pytest.importorskip("parselmouth")

import jax.numpy as jnp

from modulation_mfcc.models.config import F0Config, FormantConfig
from modulation_mfcc.models.formants import extract_formants
from modulation_mfcc.ops.pitch import pitch_ac

SR = 10_000


def _speech(dur=1.0):
    t = np.arange(int(dur * SR)) / SR
    f0 = 120 + 30 * np.sin(2 * np.pi * 2.0 * t)
    ph = 2 * np.pi * np.cumsum(f0) / SR
    return sum((0.6 / k) * np.sin(k * ph) for k in range(1, 6))


def test_f0_vs_praat_ac():
    from parselmouth.praat import call

    y = _speech()
    snd = parselmouth.Sound(values=y, sampling_frequency=SR, start_time=0.0)
    pobj = call(snd, "To Pitch (ac)", 0.01, 75, 15, False, 0.03, 0.45, 0.01, 0.35, 0.14, 600)
    praat_f0 = pobj.selected_array["frequency"]
    ours = np.asarray(pitch_ac(jnp.asarray(y, dtype=jnp.float32), sr=float(SR)))
    pv = praat_f0[praat_f0 > 20]
    ov = ours[ours > 0]
    # tolerance parity (SURVEY.md §7): medians within 2 Hz, voicing rates close
    assert abs(np.median(pv) - np.median(ov)) < 2.0
    assert abs(len(pv) / len(praat_f0) - len(ov) / len(ours)) < 0.15


def test_f0_vs_praat_ac_very_accurate():
    from parselmouth.praat import call

    y = _speech()
    snd = parselmouth.Sound(values=y, sampling_frequency=SR, start_time=0.0)
    pobj = call(snd, "To Pitch (ac)", 0.01, 75, 15, True, 0.03, 0.45, 0.01, 0.35, 0.14, 600)
    praat_f0 = pobj.selected_array["frequency"]
    ours = np.asarray(
        pitch_ac(jnp.asarray(y, dtype=jnp.float32), sr=float(SR), very_accurate=True)
    )
    pv = praat_f0[praat_f0 > 20]
    ov = ours[ours > 0]
    assert abs(np.median(pv) - np.median(ov)) < 2.0
    assert abs(len(pv) / len(praat_f0) - len(ov) / len(ours)) < 0.15


def test_f0_vs_praat_cc():
    from parselmouth.praat import call

    y = _speech()
    snd = parselmouth.Sound(values=y, sampling_frequency=SR, start_time=0.0)
    pobj = call(snd, "To Pitch (cc)", 0.01, 75, 15, False, 0.03, 0.45, 0.01, 0.35, 0.14, 600)
    praat_f0 = pobj.selected_array["frequency"]
    ours = np.asarray(
        pitch_ac(jnp.asarray(y, dtype=jnp.float32), sr=float(SR), method="cc")
    )
    pv = praat_f0[praat_f0 > 20]
    ov = ours[ours > 0]
    assert abs(np.median(pv) - np.median(ov)) < 2.0


def test_formants_vs_praat_burg():
    y = _speech()
    snd = parselmouth.Sound(values=y, sampling_frequency=SR, start_time=0.0)
    fobj = snd.to_formant_burg()
    praat_f1 = np.array([fobj.get_value_at_time(1, t) for t in fobj.ts()])
    t, (f1, f2, f3) = extract_formants(y, SR, FormantConfig(energy_threshold=0.0))
    assert abs(np.nanmedian(praat_f1) - np.nanmedian(f1)) < 100.0
