"""Pinned regression goldens for the Praat-class trackers.

The synthetic-ground-truth tests (test_pitch/test_formants) assert behavior
at tolerance; they would not catch a refactor that shifts every tracker
output by a systematic-but-small amount. These tests freeze the current
F0 / formant / intensity outputs on the deterministic speechlike fixture as
committed arrays, so tracker refactors cannot silently regress.

Regenerate after an INTENTIONAL tracker change with:
    MODMFCC_REGEN_GOLDENS=1 python -m pytest tests/test_goldens.py -q
and review the numeric drift in the git diff of the .npz files.
"""
import os

import numpy as np
import pytest

import jax.numpy as jnp

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
REGEN = os.environ.get("MODMFCC_REGEN_GOLDENS") == "1"


def _check(name: str, arrays: dict[str, np.ndarray], atol: float):
    path = os.path.join(GOLDEN_DIR, name + ".npz")
    if REGEN:
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        np.savez(path, **arrays)
        pytest.skip(f"regenerated {path}")
    if not os.path.exists(path):
        pytest.fail(f"golden {path} missing — run with MODMFCC_REGEN_GOLDENS=1")
    want = np.load(path)
    for k, v in arrays.items():
        np.testing.assert_allclose(
            np.asarray(v, dtype=np.float64),
            want[k],
            atol=atol,
            equal_nan=True,
            err_msg=f"{name}:{k} drifted from the pinned golden",
        )


def test_golden_f0_ac(speechlike):
    from modulation_mfcc.models.config import F0Config
    from modulation_mfcc.models.pitch import extract_f0

    y, sr = speechlike
    f0, t = extract_f0(y, sr, F0Config(outFilter=None, interpUnvoiced=None))
    _check("f0_ac", {"f0": f0, "t": t}, atol=0.05)


def test_golden_f0_cc(speechlike):
    from modulation_mfcc.models.config import F0Config
    from modulation_mfcc.models.pitch import extract_f0

    y, sr = speechlike
    f0, t = extract_f0(
        y, sr, F0Config(method="praatcc", outFilter=None, interpUnvoiced=None)
    )
    _check("f0_cc", {"f0": f0, "t": t}, atol=0.05)


def test_golden_f0_pyin(speechlike):
    from modulation_mfcc.models.config import F0Config
    from modulation_mfcc.models.pitch import extract_f0

    y, sr = speechlike
    f0, t = extract_f0(
        y, sr, F0Config(method="pyin", outFilter=None, interpUnvoiced=None)
    )
    _check("f0_pyin", {"f0": f0, "t": t}, atol=0.05)


def test_golden_formants(speechlike):
    from modulation_mfcc.models.config import FormantConfig
    from modulation_mfcc.models.formants import extract_formants

    y, sr = speechlike
    t, (f1, f2, f3) = extract_formants(y, sr, FormantConfig())
    _check("formants", {"t": t, "f1": f1, "f2": f2, "f3": f3}, atol=0.5)


def test_golden_intensity(speechlike):
    from modulation_mfcc.ops.intensity import intensity_db

    y, sr = speechlike
    db = intensity_db(jnp.asarray(y, dtype=jnp.float32), sr=float(sr), min_pitch=100.0)
    _check("intensity", {"db": np.asarray(db)}, atol=0.01)


def test_golden_rmspraat(speechlike):
    from modulation_mfcc.models.pitch_adaptive import praat_style_intensity

    y, sr = speechlike
    amp, rate = praat_style_intensity(jnp.asarray(y, dtype=jnp.float32), sr)
    _check(
        "rmspraat",
        {"amp": np.asarray(amp), "rate": np.asarray([rate])},
        atol=0.01,
    )
