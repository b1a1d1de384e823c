"""Deltas + CMVN (BASELINE config #2) and long-form auto-dispatch."""
import numpy as np
import scipy.signal as sps

import jax.numpy as jnp

from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.models.features import cmvn, delta, mfcc_with_deltas
from modulation_mfcc.models.modulation import extract_mfcc_change


def test_delta_matches_librosa_formula(rng):
    # librosa.feature.delta == savgol_filter(width, polyorder=order,
    # deriv=order, mode='interp') over the frame axis
    m = rng.standard_normal((40, 13))
    got = np.asarray(delta(jnp.asarray(m)))
    want = sps.savgol_filter(m, 9, polyorder=1, deriv=1, axis=0, mode="interp")
    np.testing.assert_allclose(got, want, atol=1e-8)
    got2 = np.asarray(delta(jnp.asarray(m), order=2))
    want2 = sps.savgol_filter(m, 9, polyorder=2, deriv=2, axis=0, mode="interp")
    np.testing.assert_allclose(got2, want2, atol=1e-8)


def test_cmvn_masked(rng):
    m = rng.standard_normal((2, 50, 13))
    mask = np.ones((2, 50), np.float32)
    mask[1, 30:] = 0.0
    out = np.asarray(cmvn(jnp.asarray(m), frame_mask=jnp.asarray(mask)))
    # valid region of item 1: zero mean, unit variance
    v = out[1, :30]
    np.testing.assert_allclose(v.mean(axis=0), 0.0, atol=1e-6)
    np.testing.assert_allclose(v.std(axis=0), 1.0, atol=1e-4)
    # padded region zeroed
    np.testing.assert_array_equal(out[1, 30:], 0.0)
    # masked stats must equal per-item stats of the valid slice
    direct = (m[1, :30] - m[1, :30].mean(0)) / (m[1, :30].std(0) + 1e-8)
    np.testing.assert_allclose(v, direct, atol=1e-5)


def test_mfcc_with_deltas_shape(rng):
    m = rng.standard_normal((2, 60, 13))
    mask = np.ones((2, 60), np.float32)
    out = np.asarray(mfcc_with_deltas(jnp.asarray(m), frame_mask=jnp.asarray(mask), normalize=True))
    assert out.shape == (2, 60, 39)
    assert np.all(np.isfinite(out))


def test_longform_auto_dispatch(rng):
    """Above the threshold the single-file extract routes through the
    chunked streaming path and matches the standard path."""
    cfg = MfccConfig(n_fft=256, n_mels=40)
    n = 300_000
    y = rng.standard_normal(n).astype(np.float32)
    a, ta = extract_mfcc_change(y, cfg, longform_threshold=250_000)
    b, tb = extract_mfcc_change(y, cfg, longform_threshold=10**9)
    assert a.shape == b.shape == ta.shape
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4)
