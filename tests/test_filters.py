"""Parity of device-side filtering vs scipy (the exact library the reference
calls: script/mfcc.py:398-402, 417-425; script/calc.py:93-127)."""
import numpy as np
import pytest
import scipy.signal as sps

import jax.numpy as jnp

from modulation_mfcc.ops import filters as F
from modulation_mfcc.ops.savgol import savgol_filter_jax
from modulation_mfcc.ops.derivatives import findiff_apply, np_gradient, velocity


@pytest.fixture(scope="module")
def sig():
    return np.random.default_rng(20260816).standard_normal(777)


def test_odd_ext_matches_scipy(sig):
    from scipy.signal._arraytools import odd_ext as sp_odd_ext

    got = np.asarray(F.odd_ext(jnp.asarray(sig), 21))
    want = sp_odd_ext(sig, 21)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("order,cut,btype", [(6, 0.12, "lowpass"), (4, 0.3, "highpass"), (3, (0.1, 0.4), "bandpass")])
def test_sosfiltfilt_matches_scipy(sig, order, cut, btype):
    wn = cut if isinstance(cut, tuple) else (cut,)
    sos, zi, padlen = F.design_butter_sos(order, wn, btype)
    got = np.asarray(F.sosfiltfilt(sos, zi, padlen, jnp.asarray(sig)))
    want = sps.sosfiltfilt(sos, sig)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_sosfiltfilt_batched_matches_scipy(rng):
    x = rng.standard_normal((4, 12, 400))
    sos, zi, padlen = F.design_butter_sos(6, (0.12,), "lowpass")
    got = np.asarray(F.sosfiltfilt(sos, zi, padlen, jnp.asarray(x)))
    want = sps.sosfiltfilt(sos, x, axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_fir_filtfilt_matches_scipy(sig):
    b, zi, padlen = F.design_firwin(6, (0.2,), "lowpass")
    got = np.asarray(F.filtfilt(b, np.array([1.0]), zi, padlen, jnp.asarray(sig)))
    want = sps.filtfilt(b, 1.0, sig)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_apply_filter_iir_reference_path(sig):
    # the reference's applyFilter(x, sr, filt='iir', cutOff=[12], filtType='low')
    got = np.asarray(F.apply_filter(jnp.asarray(sig), 200.0, filt="iir", cut_off=(12.0,), filt_len=6, filt_type="low"))
    sos = sps.butter(6, 12 / 100.0, btype="lowpass", output="sos")
    want = sps.sosfiltfilt(sos, sig)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-10)


def test_apply_filter_validation():
    x = jnp.zeros(100)
    with pytest.raises(ValueError):
        F.apply_filter(x, 100.0, filt="iir", cut_off=(60.0,))  # >= Nyquist
    with pytest.raises(ValueError):
        F.apply_filter(x, 100.0, filt="iir", cut_off=(30.0, 10.0), filt_type="band")
    with pytest.raises(ValueError):
        F.apply_filter(x, 100.0, filt="iir", cut_off=(10.0,), filt_type="xyz")


@pytest.mark.parametrize("win,poly,deriv", [(9, 3, 0), (3, 2, 1), (7, 2, 2), (11, 4, 1)])
def test_savgol_matches_scipy(sig, win, poly, deriv):
    got = np.asarray(savgol_filter_jax(jnp.asarray(sig), win, poly, deriv=deriv))
    want = sps.savgol_filter(sig, win, poly, deriv=deriv, mode="interp")
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)


def test_savgol_batched(rng):
    x = rng.standard_normal((5, 200))
    got = np.asarray(savgol_filter_jax(jnp.asarray(x), 3, 2, deriv=1))
    want = sps.savgol_filter(x, 3, 2, deriv=1, axis=-1, mode="interp")
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)


def test_np_gradient_matches_numpy(sig):
    got = np.asarray(np_gradient(jnp.asarray(sig), 0.005))
    want = np.gradient(sig, 0.005)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("deriv,acc", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_findiff_exact_on_polynomials(deriv, acc):
    # Fornberg stencils of accuracy `acc` must differentiate polynomials of
    # degree deriv+acc-1 exactly (including the one-sided boundary rows).
    h = 0.1
    x = np.arange(50) * h
    deg = deriv + acc - 1
    coeffs = np.arange(1, deg + 2, dtype=float)
    y = np.polyval(coeffs, x)
    dcoeffs = np.polyder(coeffs, deriv)
    want = np.polyval(dcoeffs, x)
    got = np.asarray(findiff_apply(jnp.asarray(y), deriv, h, acc=acc))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_velocity_gradient_parity(sig):
    # reference get_velocity(..., method='gradient', difference=2) == double np.gradient
    got = np.asarray(velocity(jnp.asarray(sig), 1.0, difference=2, method="gradient"))
    want = np.gradient(np.gradient(sig, 1.0), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_velocity_sg_parity(sig):
    got = np.asarray(velocity(jnp.asarray(sig), 1.0, difference=1, method="sg", width=3, poly_order=2))
    want = sps.savgol_filter(sig, 3, 2, deriv=1, axis=0, mode="interp")
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-9)
