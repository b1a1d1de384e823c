"""Savitzky-Golay filtering/differentiation as a static linear operator.

scipy's ``savgol_filter(..., mode='interp')`` (used by the reference for
smoothing and derivatives: script/mfcc.py:128-131, script/mfcc.py:409-412,
script/calc.py:639-640) is a *linear* map: an interior correlation with fixed
SG coefficients plus polynomial least-squares fits on the first/last window.

Formulation: precompute (host-side, float64, via scipy itself so the
edge math is bit-identical) the interior stencil and the two edge matrices,
then apply on device as one `correlate` (a small matmul over unfolded frames)
plus two tiny matmuls for the edges. No data-dependent control flow.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.signal as _sps

import jax
import jax.numpy as jnp


@lru_cache(maxsize=128)
def _savgol_design(window_length: int, polyorder: int, deriv: int, delta: float):
    """(stencil [w], edge_op [w, w]) for savgol mode='interp'.

    ``edge_op`` is scipy's savgol_filter applied to the identity — rows
    0..half-1 and rows -half..-1 are exactly the polynomial edge fits.
    """
    coeffs = _sps.savgol_coeffs(window_length, polyorder, deriv=deriv, delta=delta)
    eye = np.eye(window_length)
    edge_op = _sps.savgol_filter(
        eye, window_length, polyorder, deriv=deriv, delta=delta, axis=0, mode="interp"
    )
    return coeffs, edge_op


def savgol_filter_jax(
    x: jnp.ndarray,
    window_length: int,
    polyorder: int,
    *,
    deriv: int = 0,
    delta: float = 1.0,
) -> jnp.ndarray:
    """scipy.signal.savgol_filter(..., mode='interp') along the last axis."""
    t = x.shape[-1]
    if t < window_length:
        raise ValueError(
            f"If mode is 'interp', window_length must be less than or equal "
            f"to the size of x ({t})."
        )
    coeffs, edge_op = _savgol_design(window_length, polyorder, deriv, float(delta))
    half = window_length // 2
    # Interior: correlation with the SG stencil. scipy applies
    # convolve1d(x, coeffs[::-1]) == correlate(x, coeffs).
    kernel = jnp.asarray(coeffs[::-1], dtype=x.dtype)
    lead = x.shape[:-1]
    xr = x.reshape((-1, 1, t))
    y = jnp.squeeze(_conv_valid(xr, kernel), axis=1)
    y = y.reshape(lead + (t - window_length + 1,))
    # y covers output indices [half, t-half-1] (valid part)
    e = jnp.asarray(edge_op, dtype=x.dtype)
    # scipy-parity surface (≤1e-8): tiny edge blocks, never let a reduced-
    # precision matmul default (TF32) round their operands
    hi = jax.lax.Precision.HIGHEST
    left = jnp.matmul(x[..., :window_length], e[:half].T, precision=hi)
    right = jnp.matmul(
        x[..., -window_length:], e[window_length - half :].T, precision=hi
    )
    return jnp.concatenate([left, y, right], axis=-1)


def _conv_valid(x: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """VALID cross-correlation of x [B,1,T] with kernel [w] → [B,1,T-w+1]."""
    import jax

    k = kernel[None, None, :]
    return jax.lax.conv_general_dilated(
        x, k, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
    )
