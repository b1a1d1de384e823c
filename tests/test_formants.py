"""Formant tracker validation: synthetic vowels with known resonances.

(Ground truth = the resonator frequencies used to synthesize the signal;
Praat-tolerance parity per SURVEY.md §7 — parselmouth unavailable here.)"""
import numpy as np
import scipy.signal as sps

import jax.numpy as jnp

from modulation_mfcc.models.config import FormantConfig
from modulation_mfcc.models.formants import extract_formants, formants_with_gating
from modulation_mfcc.ops.lpc import burg_lpc, poly_roots_dk

SR = 10_000


def synth_vowel(formants, bws, f0=110.0, dur=0.8, sr=SR):
    """Impulse train through cascaded two-pole resonators."""
    n = int(dur * sr)
    src = np.zeros(n)
    period = int(sr / f0)
    src[::period] = 1.0
    src = np.diff(np.concatenate([[0.0], src]))  # differentiated pulse
    y = src
    for fc, bw in zip(formants, bws):
        r = np.exp(-np.pi * bw / sr)
        theta = 2 * np.pi * fc / sr
        a = [1.0, -2 * r * np.cos(theta), r * r]
        y = sps.lfilter([1.0], a, y)
    return y / np.abs(y).max()


def test_burg_matches_known_ar_process(rng):
    # AR(4) process with known poles; Burg must recover the coefficients
    true_a = np.array([-2.2137, 2.4271, -1.4699, 0.4621])  # stable AR(4)
    x = sps.lfilter([1.0], np.concatenate([[1.0], true_a]), rng.standard_normal(4096))
    a = np.asarray(burg_lpc(jnp.asarray(x[None, :], dtype=jnp.float64), 4))[0]
    np.testing.assert_allclose(a, true_a, atol=0.03)


def test_poly_roots_dk_known_roots():
    # (z-0.5)(z-(0.3+0.4j))(z-(0.3-0.4j))(z+0.8)
    roots = np.array([0.5, 0.3 + 0.4j, 0.3 - 0.4j, -0.8])
    coeffs = np.poly(roots)[1:]  # monic → drop leading 1
    got = np.sort_complex(np.asarray(poly_roots_dk(jnp.asarray(coeffs, dtype=jnp.complex64))))
    np.testing.assert_allclose(np.sort_complex(roots), got, atol=1e-3)


def synth_vowel_noise(formants, bws, dur=0.8, sr=SR, seed=0):
    """White-noise excitation through cascaded two-pole resonators."""
    rng = np.random.default_rng(seed)
    y = rng.standard_normal(int(dur * sr))
    for fc, bw in zip(formants, bws):
        r = np.exp(-np.pi * bw / sr)
        theta = 2 * np.pi * fc / sr
        y = sps.lfilter([1.0], [1.0, -2 * r * np.cos(theta), r * r], y)
    return y / np.abs(y).max()


def test_vowel_formants_recovered():
    """F1/F2 slots land on the true resonances; every true resonance is
    found among the pole set. (Formant-*slot* semantics follow Praat: the
    k-th lowest in-range pole is Fk, so a wide-bandwidth spurious pole can
    occupy a slot — Praat reports the same for such signals.)"""
    target = [700.0, 1200.0, 2600.0]
    y = synth_vowel_noise(target, [60.0, 90.0, 150.0])
    t, (f1, f2, f3) = extract_formants(y, SR, FormantConfig(energy_threshold=20.0))
    assert len(t) > 20
    assert abs(np.nanmedian(f1) - 700) < 60
    assert abs(np.nanmedian(f2) - 1200) < 90
    # all three true resonances present among the full pole set
    import jax.numpy as jnp

    from modulation_mfcc.io.wav import resample
    from modulation_mfcc.ops.lpc import lpc_formants

    xr = resample(y, SR, 11_000)
    freqs, bw = lpc_formants(jnp.asarray(xr, dtype=jnp.float32), sr=11_000.0)
    med = np.nanmedian(np.asarray(freqs), axis=0)
    for want in target:
        nearest = np.nanmin(np.abs(med - want))
        assert nearest < 100, f"resonance {want}: nearest pole {nearest} away"


def test_intensity_gating_drops_silence():
    y = np.concatenate([
        np.zeros(SR // 2),
        synth_vowel([600, 1400, 2500], [80, 100, 160], dur=0.5),
    ])
    t_all, f123, keep = formants_with_gating(y, SR, FormantConfig(energy_threshold=40.0))
    # frames in the silent first half must be gated out
    silent = t_all < 0.4
    assert keep[silent].mean() < 0.2
    assert keep[~silent].mean() > 0.5


def test_burg_recursion_matches_published_oracle(rng):
    """burg_lpc vs the float64 Burg recursion written straight from the
    published Andersen recursion (oracle.burg_np) — VERDICT r2 #4."""
    from modulation_mfcc.ops.lpc import burg_lpc
    from modulation_mfcc.oracle import burg_np

    frames = rng.standard_normal((6, 550))
    for order in (8, 10, 16):
        got = np.asarray(burg_lpc(jnp.asarray(frames), order))
        want = np.stack([burg_np(f, order) for f in frames])
        np.testing.assert_allclose(got, want, atol=1e-10)


def test_lpc_formants_matches_float64_oracle(speechlike):
    """Full formant chain (pre-emphasis → Praat Gaussian window → Burg →
    roots → band filter → sort) vs the float64 oracle using np.roots
    instead of Durand-Kerner. NaN patterns identical; freqs/bandwidths to
    sub-Hz."""
    from modulation_mfcc.ops.lpc import lpc_formants
    from modulation_mfcc.oracle import praat_formants_np

    y, sr = speechlike
    y = y[: sr]
    got_f, got_b = lpc_formants(
        jnp.asarray(y), sr=float(sr), max_formant=sr / 2
    )
    _, want_f, want_b = praat_formants_np(y, sr, max_formant=sr / 2)
    got_f, got_b = np.asarray(got_f), np.asarray(got_b)
    np.testing.assert_array_equal(np.isfinite(got_f), np.isfinite(want_f))
    m = np.isfinite(want_f)
    np.testing.assert_allclose(got_f[m], want_f[m], atol=0.05)
    mb = m & np.isfinite(want_b) & np.isfinite(got_b)
    np.testing.assert_allclose(got_b[mb], want_b[mb], atol=0.05)


def test_lpc_formants_oracle_nondefault_config(speechlike):
    """Oracle parity away from the Praat defaults: order 8 (4 formants),
    shorter window, coarser step, higher pre-emphasis — exercises the
    window/geometry/order plumbing the defaults test can't distinguish
    (all reference-exposed knobs, script/calc.py:131-148)."""
    from modulation_mfcc.ops.lpc import lpc_formants
    from modulation_mfcc.oracle import praat_formants_np

    y, sr = speechlike
    y = y[: sr]
    kw = dict(
        window_length=0.015, time_step=0.01, pre_emphasis_from=75.0,
        max_formant=sr / 2,
    )
    got_f, got_b = lpc_formants(
        jnp.asarray(y), sr=float(sr), order=8, **kw
    )
    _, want_f, want_b = praat_formants_np(y, sr, max_formants=4.0, **kw)
    got_f, got_b = np.asarray(got_f), np.asarray(got_b)
    np.testing.assert_array_equal(np.isfinite(got_f), np.isfinite(want_f))
    m = np.isfinite(want_f)
    assert m.sum() > 20
    np.testing.assert_allclose(got_f[m], want_f[m], atol=0.05)
    mb = m & np.isfinite(want_b) & np.isfinite(got_b)
    np.testing.assert_allclose(got_b[mb], want_b[mb], atol=0.05)
