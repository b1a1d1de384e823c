"""Numerical differentiation: gradient, finite-difference stencils, SG deriv.

Device-side equivalents of the reference's velocity/acceleration stack
(script/calc.py:593-650 ``get_velocity``): all three methods reduce to fixed
stencil correlations + small edge matmuls with design-time (host, float64)
coefficients — fully fused by XLA, no per-sample Python.

  * 'gradient' — np.gradient semantics (central interior, 1st-order one-sided
    edges, edge_order=1 default), applied ``difference`` times
    (script/calc.py:642-645).
  * 'sg'       — Savitzky-Golay derivative (scipy savgol mode='interp'),
    see ops/savgol.py.
  * 'finDiff'  — findiff.FinDiff(0, 1/sr, difference, acc=accOrder)
    semantics: central stencil of accuracy ``acc`` in the interior, one-sided
    stencils of the same accuracy at the boundaries. Stencil weights are
    generated with the Fornberg algorithm (findiff itself is not a runtime
    dependency).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from modulation_mfcc.ops.savgol import savgol_filter_jax


def np_gradient(x: jnp.ndarray, spacing: float = 1.0) -> jnp.ndarray:
    """np.gradient along the last axis (edge_order=1), the reference's default
    derivative (script/mfcc.py:407, script/calc.py:644)."""
    inv2h = 1.0 / (2.0 * spacing)
    invh = 1.0 / spacing
    interior = (x[..., 2:] - x[..., :-2]) * inv2h
    left = (x[..., 1:2] - x[..., :1]) * invh
    right = (x[..., -1:] - x[..., -2:-1]) * invh
    return jnp.concatenate([left, interior, right], axis=-1)


def fornberg_weights(m: int, x0: float, grid: np.ndarray) -> np.ndarray:
    """Finite-difference weights for the m-th derivative at x0 on ``grid``.

    Fornberg (1988) recursion; returns weights [len(grid)] (float64).
    """
    n = len(grid)
    delta = np.zeros((m + 1, n, n))
    delta[0, 0, 0] = 1.0
    c1 = 1.0
    for nn in range(1, n):
        c2 = 1.0
        for nu in range(nn):
            c3 = grid[nn] - grid[nu]
            c2 *= c3
            for mm in range(min(nn, m) + 1):
                delta[mm, nn, nu] = (
                    (grid[nn] - x0) * delta[mm, nn - 1, nu]
                    - mm * delta[mm - 1, nn - 1, nu]
                ) / c3
        for mm in range(min(nn, m) + 1):
            delta[mm, nn, nn] = (
                c1
                / c2
                * (
                    mm * delta[mm - 1, nn - 1, nn - 1]
                    - (grid[nn - 1] - x0) * delta[mm, nn - 1, nn - 1]
                )
            )
        c1 = c2
    return delta[m, n - 1, :]


@lru_cache(maxsize=128)
def findiff_stencils(deriv: int, acc: int, spacing: float):
    """(central [w], forward [L], backward [L], half) findiff-style stencils.

    Central stencil has ``2*floor((deriv+1)/2) - 1 + acc`` points; one-sided
    stencils have one extra point when ``deriv`` is even (findiff convention).
    Weights already divided by spacing**deriv.
    """
    num_central = 2 * ((deriv + 1) // 2) - 1 + acc
    half = num_central // 2
    central_grid = np.arange(-half, half + 1, dtype=np.float64)
    num_side = num_central + (1 if deriv % 2 == 0 else 0)
    fwd_grid = np.arange(num_side, dtype=np.float64)
    scale = spacing ** (-deriv)
    central = fornberg_weights(deriv, 0.0, central_grid) * scale
    forward = fornberg_weights(deriv, 0.0, fwd_grid) * scale
    backward = fornberg_weights(deriv, 0.0, -fwd_grid[::-1]) * scale
    return central, forward, backward, half


def findiff_apply(x: jnp.ndarray, deriv: int, spacing: float, acc: int = 2) -> jnp.ndarray:
    """findiff.FinDiff(0, spacing, deriv, acc=acc) along the last axis."""
    central, forward, backward, half = findiff_stencils(deriv, acc, float(spacing))
    t = x.shape[-1]
    w = len(central)
    L = len(forward)
    if t < max(w, L):
        raise ValueError(f"Signal length {t} too short for stencil ({max(w, L)})")
    # conv_general_dilated is cross-correlation: y[i] = Σ_j k[j]·x[i+j], which
    # is exactly the stencil application for offsets -half..half — no flip.
    kernel = jnp.asarray(central, dtype=x.dtype)[None, None, :]
    xr = x.reshape((-1, 1, t))
    interior = jax.lax.conv_general_dilated(
        xr, kernel, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=jax.lax.Precision.HIGHEST,
    )[:, 0, :].reshape(x.shape[:-1] + (t - w + 1,))
    # Boundary rows: same one-sided stencil anchored at each of the first/last
    # `half` samples (findiff convention).
    fw = jnp.asarray(forward, dtype=x.dtype)
    bw = jnp.asarray(backward, dtype=x.dtype)
    hi = jax.lax.Precision.HIGHEST
    lefts = [
        jnp.tensordot(x[..., i : i + L], fw, axes=[[-1], [0]], precision=hi)[..., None]
        for i in range(half)
    ]
    rights = [
        jnp.tensordot(
            x[..., t - (half - i) - L + 1 : t - (half - i) + 1], bw,
            axes=[[-1], [0]], precision=hi,
        )[..., None]
        for i in range(half)
    ]
    return jnp.concatenate(lefts + [interior] + rights, axis=-1)


def velocity(
    x: jnp.ndarray,
    sr: float,
    *,
    difference: int = 1,
    method: str = "gradient",
    width: int = 3,
    acc_order: int = 2,
    poly_order: int = 2,
) -> jnp.ndarray:
    """Reference get_velocity (script/calc.py:593-650) along the last axis.

    Note: the app layer calls this with sr=1.0 (per-sample derivative,
    reference script/main.py:683) — callers must preserve that quirk for
    parity with the GUI's Velocity/Acceleration curves.
    """
    if method == "finDiff":
        return findiff_apply(x, difference, 1.0 / sr, acc=acc_order)
    if method == "sg":
        return savgol_filter_jax(x, width, poly_order, deriv=difference)
    if method == "gradient":
        for _ in range(difference):
            x = np_gradient(x, 1.0 / sr)
        return x
    raise ValueError("Méthode inconnue. Utilisez 'gradient', 'sg' ou 'finDiff'.")
