"""Masked FIR-operator filtfilt + the bucketed extract dispatch paths."""
import numpy as np
import scipy.signal as sps

import jax.numpy as jnp

from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.models.modulation import extract_mfcc_change, min_frames_for_fir
from modulation_mfcc.ops import filters as F
from modulation_mfcc.ops.masked import masked_sosfiltfilt_fir
from modulation_mfcc.oracle import get_mfccs_change_np


def test_masked_fir_matches_scipy(rng):
    sos, zi, padlen = F.design_butter_sos(6, (0.12,), "lowpass")
    d = F.design_filtfilt_operator(F._key_of(sos), padlen)
    assert d is not None
    t_buf = 2048
    for L in (d.min_len, d.min_len + 123, 1500, 2048):
        x = rng.standard_normal(t_buf)
        buf = np.zeros(t_buf)
        buf[:L] = x[:L]
        got = np.asarray(masked_sosfiltfilt_fir(d, jnp.asarray(buf), L))
        want = sps.sosfiltfilt(sos, x[:L])
        np.testing.assert_allclose(got[:L], want, rtol=1e-7, atol=1e-8)


def test_masked_fir_multichannel(rng):
    sos, zi, padlen = F.design_butter_sos(6, (0.12,), "lowpass")
    d = F.design_filtfilt_operator(F._key_of(sos), padlen)
    L, t_buf = 900, 1024
    x = rng.standard_normal((12, t_buf))
    buf = np.zeros((12, t_buf))
    buf[:, :L] = x[:, :L]
    got = np.asarray(masked_sosfiltfilt_fir(d, jnp.asarray(buf), L))
    want = sps.sosfiltfilt(sos, x[:, :L], axis=-1)
    np.testing.assert_allclose(got[:, :L], want, rtol=1e-7, atol=1e-8)


def test_extract_long_file_uses_fir_path_with_parity(rng):
    """A file above the FIR min-frames threshold goes through the masked-FIR
    device path and must still match the f64 oracle at 1e-4."""
    cfg = MfccConfig()
    mf = min_frames_for_fir(cfg)
    assert mf is not None
    sr = cfg.signal_sample_rate
    n = (mf + 50) * cfg.hop_length  # comfortably above the threshold
    t = np.arange(n) / sr
    y = 0.6 * np.sin(2 * np.pi * 130 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    y += 0.01 * rng.standard_normal(n)
    tot, times = extract_mfcc_change(y, cfg)
    want, t_want = get_mfccs_change_np(y.astype(np.float64), sr)
    assert tot.shape == want.shape
    np.testing.assert_allclose(np.asarray(tot), want, atol=1e-4)
    np.testing.assert_allclose(times, t_want, atol=1e-9)


def test_extract_short_file_host_tail_parity(rng):
    """A short file (below min-frames) uses the host scipy tail — still
    oracle-exact."""
    cfg = MfccConfig()
    sr = cfg.signal_sample_rate
    y = 0.5 * np.sin(2 * np.pi * 150 * np.arange(8000) / sr)
    y += 0.01 * rng.standard_normal(8000)
    tot, times = extract_mfcc_change(y, cfg)
    want, _ = get_mfccs_change_np(y.astype(np.float64), sr)
    assert tot.shape == want.shape
    np.testing.assert_allclose(np.asarray(tot), want, atol=1e-4)


def test_bucket_sharing_same_compiled_shape():
    """Two different lengths in one bucket produce correct per-length outputs
    (shapes differ on output, padded shapes shared)."""
    cfg = MfccConfig()
    sr = cfg.signal_sample_rate
    for n in (9_000, 12_345):
        y = np.sin(2 * np.pi * 120 * np.arange(n) / sr)
        tot, t = extract_mfcc_change(y, cfg)
        assert tot.shape == t.shape == (1 + n // cfg.hop_length,)
