"""Parity sweep across the config surface: non-default n_fft/window/filters
through the float64 oracle (guards the silent landmines of SURVEY.md §7 #6)."""
import numpy as np
import pytest

from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.models.modulation import extract_mfcc_change
from modulation_mfcc.oracle import get_mfccs_change_np


@pytest.fixture(scope="module")
def speech16k():
    rng = np.random.default_rng(7)
    sr = 16_000
    t = np.arange(int(1.6 * sr)) / sr
    y = sum((0.6 / k) * np.sin(2 * np.pi * k * 135 * t) for k in range(1, 5))
    y = y * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)) + 0.01 * rng.standard_normal(len(t))
    return y, sr


CASES = [
    dict(),  # 16 kHz defaults
    dict(n_fft=1024, winLen=0.05, tStep=0.01),
    dict(n_mfcc=20, removeFirst=0),
    dict(filtOrd=4, filtCutoff=8.0),
    dict(outFilter=None),
    dict(outFilter="fir", outFiltLen=8, outFiltCutOff=(10.0,)),
    dict(outFilter="sg", outFiltLen=9, outFiltPolyOrd=3),
    dict(diffMethod="sg"),
    dict(minFreq=50.0, maxFreq=6000.0),
]


@pytest.mark.parametrize("overrides", CASES)
def test_config_surface_parity(speech16k, overrides):
    y, sr = speech16k
    kwargs = {"signal_sample_rate": sr, "maxFreq": 8000.0}
    kwargs.update(overrides)
    cfg = MfccConfig(**kwargs)
    got, t = extract_mfcc_change(y, cfg)
    want, t_want = get_mfccs_change_np(
        y.astype(np.float64), sr,
        t_step=cfg.tStep, win_len=cfg.winLen, n_mfcc=cfg.n_mfcc,
        n_fft=cfg.n_fft, min_freq=cfg.minFreq, max_freq=cfg.maxFreq,
        remove_first=cfg.removeFirst, filt_cutoff=cfg.filtCutoff,
        filt_ord=cfg.filtOrd, diff_method="grad" if cfg.diffMethod == "grad" else "sg",
        out_filter=cfg.outFilter, out_filt_cutoff=cfg.outFiltCutOff,
        out_filt_len=cfg.outFiltLen,
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(t), t_want, atol=1e-9)
    np.testing.assert_allclose(np.asarray(got), want, atol=1e-4, rtol=0)
