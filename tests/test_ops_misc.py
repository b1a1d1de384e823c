"""Parity tests: hilbert, NaN interpolation, peak finding, RMS envelope."""
import numpy as np
import pytest
import scipy.signal as sps
from scipy.interpolate import PchipInterpolator, interp1d

import jax.numpy as jnp

from modulation_mfcc.models.config import AmplitudeConfig
from modulation_mfcc.models.envelope import extract_envelope, rms_envelope
from modulation_mfcc.ops.hilbert import hilbert_envelope
from modulation_mfcc.ops.interp import interp_nan
from modulation_mfcc.ops.peaks import peak_mask, peaks_in_interval


@pytest.mark.parametrize("n", [256, 257])
def test_hilbert_matches_scipy(rng, n):
    x = rng.standard_normal(n)
    got = np.asarray(hilbert_envelope(jnp.asarray(x)))
    want = np.abs(sps.hilbert(x))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def _nan_signal(rng, n=200):
    x = np.sin(np.linspace(0, 6, n)) + 0.1 * rng.standard_normal(n)
    x[30:40] = np.nan
    x[90:91] = np.nan
    x[150:170] = np.nan
    return x


def test_interp_nan_linear_interior_and_edges(rng):
    x = _nan_signal(rng)
    x[:5] = np.nan
    x[-7:] = np.nan
    got = np.asarray(interp_nan(jnp.asarray(x), "linear"))
    valid = ~np.isnan(x)
    f = interp1d(np.where(valid)[0], x[valid], "linear", fill_value="extrapolate")
    want = x.copy()
    want[~valid] = f(np.where(~valid)[0])
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_interp_nan_pchip_interior(rng):
    x = _nan_signal(rng)
    got = np.asarray(interp_nan(jnp.asarray(x), "pchip"))
    valid = ~np.isnan(x)
    f = PchipInterpolator(np.where(valid)[0], x[valid], extrapolate=False)
    want = x.copy()
    want[~valid] = f(np.where(~valid)[0])
    # interior plateaus only; scipy's 3-point edge rule differs slightly at
    # the first/last valid points, so compare away from grid edges
    np.testing.assert_allclose(got[5:-5], want[5:-5], rtol=1e-6, atol=1e-6)


def test_interp_nan_no_nans_passthrough(rng):
    x = rng.standard_normal(50)
    np.testing.assert_array_equal(np.asarray(interp_nan(jnp.asarray(x))), x)


def test_peak_mask_matches_scipy(rng):
    for trial in range(5):
        y = rng.standard_normal(300)
        got = np.flatnonzero(np.asarray(peak_mask(jnp.asarray(y))))
        want, _ = sps.find_peaks(y)
        np.testing.assert_array_equal(got, want)


def test_peak_mask_plateaus():
    y = np.array([0.0, 1, 1, 1, 0, 2, 2, 0, 3, 0, 0, 1, 1])
    got = np.flatnonzero(np.asarray(peak_mask(jnp.asarray(y))))
    want, _ = sps.find_peaks(y)
    np.testing.assert_array_equal(got, want)


def test_peaks_in_interval_reference_semantics():
    t = np.linspace(0, 1, 101)
    y = np.sin(2 * np.pi * 5 * t)
    pt, pv = peaks_in_interval(t, y, (0.2, 0.8))
    want, _ = sps.find_peaks(y[(t >= 0.2) & (t <= 0.8)])
    assert len(pt) == len(want)
    assert np.all(pv > 0.9)
    pt2, pv2 = peaks_in_interval(t, y, None)
    assert len(pt2) == 0 and len(pv2) == 0


def test_rms_envelope_framing(rng):
    # librosa.feature.rms semantics: centered constant-pad framing,
    # sqrt(mean(x^2)). Construct the expected value directly.
    sr = 1000
    y = rng.standard_normal(2000)
    win, hop = 100, 10
    pad = win // 2
    ypad = np.pad(y, pad)
    nf = 1 + (len(ypad) - win) // hop
    want = np.array([
        np.sqrt(np.mean(ypad[i * hop : i * hop + win] ** 2)) for i in range(nf)
    ])
    got = np.asarray(rms_envelope(jnp.asarray(y), win, hop))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_extract_envelope_rms_with_filter(rng):
    sr = 10_000
    y = rng.standard_normal(sr)
    cfg = AmplitudeConfig(method="RMS", outFilter="iir", outFiltCutOff=(12.0,))
    amp, t = extract_envelope(y, sr, cfg)
    assert amp.shape == t.shape
    assert np.all(np.isfinite(np.asarray(amp)))
    # parity: out-filter stage == scipy sosfiltfilt of the raw RMS envelope
    # (envelope rate = 1/hopLen = 100 Hz, reference script/mfcc.py:255-257)
    cfg0 = AmplitudeConfig(method="RMS")
    amp0, _ = extract_envelope(y, sr, cfg0)
    import scipy.signal as sps

    sos = sps.butter(6, 12.0 / (100.0 / 2.0), btype="lowpass", output="sos")
    want = sps.sosfiltfilt(sos, np.asarray(amp0, dtype=np.float64))
    np.testing.assert_allclose(np.asarray(amp), want, atol=1e-4)


def test_extract_envelope_hilb(rng):
    sr = 10_000
    y = np.sin(2 * np.pi * 100 * np.arange(sr) / sr)
    cfg = AmplitudeConfig(method="Hilb")
    amp, t = extract_envelope(y, sr, cfg)
    assert amp.shape[-1] == sr
    # Hilbert envelope of a pure tone ≈ 1
    np.testing.assert_allclose(np.asarray(amp)[100:-100], 1.0, atol=1e-2)
    # reference time-axis quirk: arange(n) * hopLen
    np.testing.assert_allclose(t, np.arange(sr) * cfg.hopLen)


def test_extract_envelope_rmspraat():
    """Pitch-adaptive intensity path (reference RMSpraat, mfcc.py:208-240):
    two-pass pitch quantiles size the window; output in dB."""
    sr = 10_000
    t = np.arange(sr) / sr
    y = 0.5 * sum((0.7 / k) * np.sin(2 * np.pi * k * 150 * t) for k in range(1, 4))
    amp, tt = extract_envelope(y, sr, AmplitudeConfig(method="RMSpraat"))
    amp = np.asarray(amp)
    assert amp.shape == tt.shape
    # dB scale: a mid-scale tone sits far above the hearing-threshold ref
    assert 40 < np.median(amp) < 110
    # min observed pitch ~150 > 120 → hop-rate output (1/hopLen = 100 Hz)
    assert len(amp) < sr / 50


def test_rms_envelope_fallback_tiny_hop(rng):
    # hop=1 forces the gathered-framing fallback (W/hop > 64); both paths
    # must agree with the direct construction
    y = rng.standard_normal(500)
    win, hop = 100, 1
    pad = win // 2
    ypad = np.pad(y, pad)
    nf = 1 + (len(ypad) - win) // hop
    want = np.array([
        np.sqrt(np.mean(ypad[i * hop : i * hop + win] ** 2)) for i in range(nf)
    ])
    got = np.asarray(rms_envelope(jnp.asarray(y), win, hop))
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_frame_by_slices_offset_grid(rng):
    from modulation_mfcc.ops.framing import frame_by_slices

    y = rng.standard_normal((2, 777))
    s0, W, H = 13, 64, 10
    nf = (y.shape[-1] - s0 - W) // H
    got = np.asarray(frame_by_slices(jnp.asarray(y), s0, nf, W, H))
    want = np.stack([y[..., s0 + k * H : s0 + k * H + W] for k in range(nf)], axis=-2)
    np.testing.assert_array_equal(got, want)


def test_resample_poly_device_matches_host(rng):
    from modulation_mfcc.io.wav import resample
    from modulation_mfcc.ops.resample import resample_device

    for orig, tgt in ((10_000, 11_000), (44_100, 10_000), (16_000, 10_000)):
        x = rng.standard_normal(8011)
        want = resample(x, orig, tgt)
        got = np.asarray(resample_device(jnp.asarray(x), float(orig), float(tgt)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-10)


def test_resample_poly_device_blocked_matches_flat(rng):
    """The blocked long-signal conv path (row framing, used above the
    layout threshold — see resample_poly_device docstring) is element-
    equal to the flat path up to conv reduction-order noise (the virtual
    8-device host platform partitions the two shapes differently — bitwise
    equality holds on a plain single-device CPU but not under the test
    mesh), including ragged tail rows, up-/down-sampling, and batched
    leading dims."""
    from modulation_mfcc.ops.resample import resample_poly_device

    for up, dn, n in ((1, 3, 10_000), (3, 2, 8_011), (160, 441, 9_000), (2, 3, 4_097)):
        x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        want = np.asarray(resample_poly_device(x, up, dn))
        got = np.asarray(
            resample_poly_device(x, up, dn, block_rows=7, block_threshold=0)
        )
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    xb = jnp.asarray(rng.standard_normal((2, 3, 5_000)).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(resample_poly_device(xb, 1, 3, block_rows=5, block_threshold=0)),
        np.asarray(resample_poly_device(xb, 1, 3)),
        rtol=1e-6, atol=1e-6,
    )


def test_hop_window_sums_edges(rng):
    from modulation_mfcc.ops.framing import hop_window_sums

    y = rng.standard_normal(257)
    # (window, hop) covering rem=0, rem>0, and window < hop (q=0)
    for w, hop in ((30, 10), (25, 10), (7, 10), (10, 10)):
        nf = 1 + (len(y) - w) // hop
        want = np.array([y[f*hop : f*hop + w].sum() for f in range(nf)])
        got = np.asarray(hop_window_sums(jnp.asarray(y), nf, w, hop))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_spectrogram_zoom_blur():
    """Reference display smoothing (praat_py_ui/spectrogram.py:70-71):
    order-4 spline zoom ×6 with matching re-gridded axes."""
    from modulation_mfcc.models.sound import praat_spectrogram

    sr = 10_000
    t = np.arange(sr // 2) / sr
    y = np.sin(2 * np.pi * 800 * t)
    plain = praat_spectrogram(y, sr)
    blurred = praat_spectrogram(y, sr, zoom_blur=True)
    assert blurred.data_matrix.shape == (plain.data_matrix.shape[0] * 6, plain.data_matrix.shape[1] * 6)
    assert blurred.timestamps[0] == plain.timestamps[0] and abs(blurred.timestamps[-1] - plain.timestamps[-1]) < 1e-9
    # the hot band stays at the tone frequency after smoothing
    hot = blurred.frequencies[np.argmax(blurred.data_matrix.mean(axis=1))]
    assert abs(hot - 800.0) < 100.0


def test_animate_position_callback_sequence():
    """Playback-cursor animation (reference main.py:2081-2098): positions
    advance monotonically start→end, then None signals cursor hide."""
    from modulation_mfcc.io.audio_device import animate_position

    seen = []
    fake_t = [0.0]

    def now():
        return fake_t[0]

    def sleep(dt):
        fake_t[0] += max(dt, 1e-3)

    animate_position(1.0, 1.1, seen.append, fps=60.0, clock=(now, sleep))
    assert seen[-1] is None
    pos = [p for p in seen if p is not None]
    assert pos[0] == 1.0 and pos[-1] == 1.1
    assert all(b >= a for a, b in zip(pos, pos[1:]))


def test_spectrogram_vs_float64_oracle():
    """Display-spectrogram parity gate (r3 verdict missing #3): the device
    praat_spectrogram vs oracle.praat_spectrogram_np (float64 framing,
    Gaussian std=nw/6 window, power rFFT, 10*log10 @ 1e-12 floor). Bars on
    the display-relevant range (within 80 dB of the per-matrix max — the
    viewer's dynamic range); below it both must agree that the bin is
    floor-dark. Speech-like content: tone + burst + silence."""
    from modulation_mfcc.models.sound import praat_spectrogram
    from modulation_mfcc.oracle import praat_spectrogram_np

    sr = 16_000
    rng = np.random.default_rng(3)
    t = np.arange(sr) / sr
    y = 0.5 * np.sin(2 * np.pi * 800 * t) * (t < 0.4)
    y[int(0.55 * sr):int(0.58 * sr)] += 0.4 * rng.standard_normal(int(0.03 * sr))
    y += 1e-4 * rng.standard_normal(sr)
    y = y.astype(np.float32)

    got = praat_spectrogram(y, sr)
    times, freqs, want = praat_spectrogram_np(y, sr)
    np.testing.assert_allclose(got.timestamps, times, atol=1e-12)
    np.testing.assert_allclose(got.frequencies, freqs, atol=1e-9)
    g = got.data_matrix.T  # [n_times, n_freqs] like the oracle
    assert g.shape == want.shape
    lively = want > want.max() - 80.0
    assert np.abs(g[lively] - want[lively]).max() <= 0.01  # dB
    # floor-dark bins stay dark on both sides (no resurrected energy)
    assert (g[~lively] < want.max() - 75.0).all()
