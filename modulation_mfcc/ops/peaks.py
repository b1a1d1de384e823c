"""Local-extrema detection with scipy.find_peaks semantics, vectorized.

Replaces the reference's peak analysis (script/calc.py:651-686 MinMaxFinder,
script/main.py:1566/1601 direct find_peaks calls). scipy's rule: a sample is
a peak if it is strictly greater than its neighbors; for a plateau of equal
values bounded by strictly smaller samples on both sides, the peak is the
plateau midpoint ``(left + right) // 2``.

Formulation: the plateau-start index is a cumulative scan
(`cummax` over "last index where the value changed"), so the whole detector
is O(n) scans + elementwise masks — no Python loops, and it returns a fixed
shape boolean mask (peak positions as a mask, not a dynamic-length index
list, so it jits/shards; hosts can `np.flatnonzero` the mask).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["peak_mask", "find_peaks_host", "peaks_in_interval"]


def peak_mask(y: jnp.ndarray) -> jnp.ndarray:
    """Boolean mask of scipy-style local maxima along the last axis."""
    n = y.shape[-1]
    if n < 3:
        return jnp.zeros_like(y, dtype=bool)
    idx = jnp.arange(n)
    changed = jnp.concatenate(
        [jnp.ones_like(y[..., :1], dtype=bool), y[..., 1:] != y[..., :-1]], axis=-1
    )
    # plateau_start[i] = largest j <= i where the value changed
    plateau_start = jax.lax.cummax(jnp.where(changed, idx, -1), axis=y.ndim - 1)
    prev_start = jnp.clip(plateau_start - 1, 0, n - 1)
    y_prev = jnp.take_along_axis(y, prev_start, axis=-1)
    rising = (plateau_start > 0) & (y_prev < y)
    nxt = jnp.concatenate([y[..., 1:], y[..., -1:]], axis=-1)
    plateau_end = idx < (n - 1)
    falling = (nxt < y) & plateau_end
    # peak plateau: ends at i (falling), started rising
    is_peak_plateau = rising & falling
    mid = (plateau_start + idx) // 2
    return _scatter_mid(y, mid, is_peak_plateau)


def _scatter_mid(y, mid, flags):
    """Scatter `flags` at positions `mid` along the last axis (max-combine)."""
    lead = y.shape[:-1]
    n = y.shape[-1]
    flat_flags = flags.reshape((-1, n))
    flat_mid = mid.reshape((-1, n))

    def one(fl, mi):
        return jnp.zeros((n,), dtype=bool).at[mi].max(fl)

    out = jax.vmap(one)(flat_flags, flat_mid)
    return out.reshape(lead + (n,))


def find_peaks_host(y: np.ndarray) -> np.ndarray:
    """Host convenience: peak indices (np.flatnonzero of the device mask)."""
    return np.flatnonzero(np.asarray(peak_mask(jnp.asarray(y))))


def peaks_in_interval(
    times: np.ndarray,
    values: np.ndarray,
    interval: tuple[float, float] | None,
    *,
    minima: bool = False,
):
    """MinMaxFinder.analyse_maximum/minimum equivalent (script/calc.py:664-686).

    Restricts to ``start <= t <= end`` (the reference's inclusive bounds,
    script/calc.py:657) and finds peaks of y (or -y for minima) *within the
    restricted segment* — like the reference, which slices first so interval
    edges can become peaks of the slice. Returns (peak_times, peak_values).
    """
    if interval is None:
        return np.array([]), np.array([])
    times = np.asarray(times)
    values = np.asarray(values)
    sel = (times >= interval[0]) & (times <= interval[1])
    t_sel, v_sel = times[sel], values[sel]
    if len(v_sel) < 3:
        return np.array([]), np.array([])
    y = -v_sel if minima else v_sel
    pk = np.flatnonzero(np.asarray(peak_mask(jnp.asarray(y))))
    return t_sel[pk], v_sel[pk]
