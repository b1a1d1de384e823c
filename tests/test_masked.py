"""Masked (variable-length) op parity + padded-batch == per-file invariance."""
import numpy as np
import pytest
import scipy.signal as sps

import jax
import jax.numpy as jnp

from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.ops import filters as F
from modulation_mfcc.ops.masked import (
    masked_gradient,
    masked_odd_ext,
    masked_savgol,
    masked_sosfiltfilt,
)
from modulation_mfcc.parallel.batch import batched_mfcc_change, pad_batch
from modulation_mfcc.oracle import get_mfccs_change_np


def test_masked_odd_ext(rng):
    x = rng.standard_normal(100)
    L, pad = 64, 9
    buf = np.zeros(100)
    buf[:L] = x[:L]
    got = np.asarray(masked_odd_ext(jnp.asarray(buf), L, pad))
    from scipy.signal._arraytools import odd_ext as sp_odd_ext

    want = sp_odd_ext(x[:L], pad)
    np.testing.assert_allclose(got[: L + 2 * pad], want, atol=1e-12)


@pytest.mark.parametrize("L", [50, 64, 99, 100])
def test_masked_sosfiltfilt(rng, L):
    x = rng.standard_normal(100)
    sos, zi, padlen = F.design_butter_sos(6, (0.12,), "lowpass")
    buf = np.zeros(100)
    buf[:L] = x[:L]
    got = np.asarray(masked_sosfiltfilt(sos, zi, padlen, jnp.asarray(buf), L))
    want = sps.sosfiltfilt(sos, x[:L])
    np.testing.assert_allclose(got[:L], want, rtol=1e-8, atol=1e-9)


def test_masked_sosfiltfilt_multichannel(rng):
    x = rng.standard_normal((12, 100))
    L = 77
    sos, zi, padlen = F.design_butter_sos(6, (0.12,), "lowpass")
    buf = np.zeros((12, 100))
    buf[:, :L] = x[:, :L]
    got = np.asarray(masked_sosfiltfilt(sos, zi, padlen, jnp.asarray(buf), L))
    want = sps.sosfiltfilt(sos, x[:, :L], axis=-1)
    np.testing.assert_allclose(got[:, :L], want, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("L", [40, 99])
def test_masked_gradient(rng, L):
    x = rng.standard_normal(100)
    buf = np.zeros(100)
    buf[:L] = x[:L]
    got = np.asarray(masked_gradient(jnp.asarray(buf), L))
    want = np.gradient(x[:L])
    np.testing.assert_allclose(got[:L], want, atol=1e-12)


@pytest.mark.parametrize("w,p,d,L", [(3, 2, 1, 60), (7, 3, 0, 80), (11, 4, 2, 95)])
def test_masked_savgol(rng, w, p, d, L):
    x = rng.standard_normal(100)
    buf = np.zeros(100)
    buf[:L] = x[:L]
    got = np.asarray(masked_savgol(jnp.asarray(buf), w, p, L, deriv=d))
    want = sps.savgol_filter(x[:L], w, p, deriv=d, mode="interp")
    np.testing.assert_allclose(got[:L], want, rtol=1e-8, atol=1e-9)


def test_padded_batch_equals_per_file(speechlike, rng):
    """The capstone invariance: batched+masked output == per-file oracle."""
    y, sr = speechlike
    cfg = MfccConfig()
    sigs = [y[: int(0.9 * len(y))], y[: int(0.6 * len(y))], y]
    batch = pad_batch(sigs, bucket_multiple=2048)
    tot_b, mask = batched_mfcc_change(batch, cfg)
    tot_b = np.asarray(tot_b)
    for i, s in enumerate(sigs):
        want, _ = get_mfccs_change_np(np.asarray(s), sr)
        nf = len(want)
        assert int(np.asarray(mask[i]).sum()) == nf
        np.testing.assert_allclose(tot_b[i, :nf], want, atol=1e-4, rtol=0)


def test_masked_ops_degenerate_lengths_finite(rng):
    """Sub-padlen / tiny lengths are outside the scipy-valid contract (the
    masked output past ``length`` is unspecified and masked downstream),
    but the VALID prefix must stay finite — the gather-free rewrite reads
    explicit zeros where the old clamped gather read edge samples, and a
    NaN/inf leak here would poison downstream reductions through the mask
    (0 * nan = nan)."""
    x = rng.standard_normal(64)
    sos = sps.butter(6, 0.2, output="sos")
    zi = sps.sosfilt_zi(sos)
    padlen = 3 * (2 * sos.shape[0] + 1)
    for L in (1, 2, 3, padlen - 1, padlen, padlen + 1):
        ext = np.asarray(masked_odd_ext(jnp.asarray(x), jnp.asarray(L), padlen))
        assert np.isfinite(ext).all(), L
        y = np.asarray(
            masked_sosfiltfilt(sos, zi, padlen, jnp.asarray(x), jnp.asarray(L))
        )
        assert np.isfinite(y[:L]).all(), L
        g = np.asarray(masked_gradient(jnp.asarray(x), jnp.asarray(L)))
        assert np.isfinite(g[:L]).all(), L
        s = np.asarray(masked_savgol(jnp.asarray(x), 9, 2, jnp.asarray(L)))
        assert np.isfinite(s[:L]).all(), L
