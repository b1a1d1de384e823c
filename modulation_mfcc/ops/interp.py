"""Gap filling for unvoiced/NaN regions — vectorized, static-shape.

Device-side equivalent of the reference's interp_NAN (script/calc.py:345-385):
instead of scipy interp1d/Pchip objects built per call, the prev/next valid
neighbor of every sample is computed with two cumulative scans and the
interpolation is a fused gather + lerp (or cubic Hermite for pchip). Works on
any leading batch shape; no dynamic shapes, so it vmaps/shards cleanly.
"""
from __future__ import annotations

import jax.numpy as jnp

__all__ = ["interp_nan", "prev_next_valid"]


def prev_next_valid(valid: jnp.ndarray):
    """For each position, index of the nearest valid sample at-or-before and
    at-or-after (−1 / n if none). ``valid`` is bool [..., n]."""
    n = valid.shape[-1]
    idx = jnp.arange(n)
    prev = jax_cummax(jnp.where(valid, idx, -1))
    rev_prev = jax_cummax(jnp.where(jnp.flip(valid, -1), idx, -1))
    nxt = jnp.where(jnp.flip(rev_prev, -1) >= 0, n - 1 - jnp.flip(rev_prev, -1), n)
    return prev, nxt


def jax_cummax(x: jnp.ndarray) -> jnp.ndarray:
    import jax

    return jax.lax.cummax(x, axis=x.ndim - 1)


def _first_two_valid(valid: jnp.ndarray):
    """Indices of the first two valid samples along the last axis."""
    n = valid.shape[-1]
    idx = jnp.arange(n)
    big = n + 1
    masked = jnp.where(valid, idx, big)
    v0 = jnp.min(masked, axis=-1)
    masked2 = jnp.where(valid & (idx > v0[..., None]), idx, big)
    v1 = jnp.min(masked2, axis=-1)
    return v0, v1


def _last_two_valid(valid: jnp.ndarray):
    n = valid.shape[-1]
    idx = jnp.arange(n)
    masked = jnp.where(valid, idx, -1)
    u1 = jnp.max(masked, axis=-1)
    masked2 = jnp.where(valid & (idx < u1[..., None]), idx, -1)
    u0 = jnp.max(masked2, axis=-1)
    return u0, u1


def _gather_last(x: jnp.ndarray, i: jnp.ndarray) -> jnp.ndarray:
    return jnp.take_along_axis(x, i, axis=-1)


def interp_nan(x: jnp.ndarray, method: str = "linear") -> jnp.ndarray:
    """Fill NaNs along the last axis.

    method='linear' matches scipy interp1d(..., fill_value='extrapolate')
    (reference script/calc.py:379-380): interior gaps are lerped between
    surrounding valid samples; leading/trailing gaps are linearly extrapolated
    from the first/last valid segment.

    method='pchip' matches the reference's pchip branch
    (script/calc.py:370-377): endpoints are first filled with the nearest
    valid value, then gaps are filled with a monotone (Fritsch-Carlson) cubic
    Hermite — scipy.PchipInterpolator semantics on the valid grid.
    """
    valid = ~jnp.isnan(x)
    all_valid = jnp.all(valid)
    if method == "pchip":
        filled = _interp_pchip(x, valid)
    else:
        filled = _interp_linear(x, valid)
    return jnp.where(valid, x, jnp.where(all_valid, x, filled))


def _interp_linear(x: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    n = x.shape[-1]
    idx = jnp.arange(n)
    prev, nxt = prev_next_valid(valid)
    v0, v1 = _first_two_valid(valid)
    u0, u1 = _last_two_valid(valid)
    pc = jnp.clip(prev, 0, n - 1)
    nc = jnp.clip(nxt, 0, n - 1)
    xz = jnp.where(valid, x, 0.0)
    xp = _gather_last(xz, pc)
    xn = _gather_last(xz, nc)
    # interior lerp
    denom = jnp.maximum(nc - pc, 1)
    t = (idx - pc) / denom
    interior = xp + t * (xn - xp)
    # extrapolation from the first/last valid segment
    def seg_val(i0, i1):
        y0 = _gather_last(xz, jnp.clip(i0, 0, n - 1)[..., None])[..., 0]
        y1 = _gather_last(xz, jnp.clip(i1, 0, n - 1)[..., None])[..., 0]
        slope = (y1 - y0) / jnp.maximum(i1 - i0, 1)
        return y0, slope, i0

    ly, lslope, li = seg_val(v0, v1)
    ry, rslope, ri = seg_val(u0, u1)
    left = ly[..., None] + lslope[..., None] * (idx - li[..., None])
    right = ry[..., None] + rslope[..., None] * (idx - ri[..., None])
    # single-valid-point degenerate case: constant fill
    one_valid = (v1 > n) | (v0 == u1)
    const = _gather_last(xz, jnp.clip(v0, 0, n - 1)[..., None])
    out = jnp.where(prev < 0, left, jnp.where(nxt >= n, right, interior))
    out = jnp.where(one_valid[..., None], const, out)
    return out


def _interp_pchip(x: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Monotone cubic Hermite on the (irregular) valid grid.

    Mirrors the reference's pchip branch: endpoints pre-filled with nearest
    valid value (script/calc.py:371-374), then PCHIP interior.
    """
    n = x.shape[-1]
    idx = jnp.arange(n)
    v0, _ = _first_two_valid(valid)
    u1c = _last_two_valid(valid)[1]
    xz = jnp.where(valid, x, 0.0)
    first_val = _gather_last(xz, jnp.clip(v0, 0, n - 1)[..., None])
    last_val = _gather_last(xz, jnp.clip(u1c, 0, n - 1)[..., None])
    x2 = jnp.where((idx == 0) & ~valid, first_val, x)
    x2 = jnp.where((idx == n - 1) & jnp.isnan(x2), last_val, x2)
    valid2 = ~jnp.isnan(x2)
    prev, nxt = prev_next_valid(valid2)
    xz2 = jnp.where(valid2, x2, 0.0)
    # derivative m_i at every valid point (Fritsch–Carlson weighted harmonic
    # mean of adjacent secant slopes; 0 at sign change — scipy pchip interior
    # rule). For grid-edge valid points scipy uses a one-sided three-point
    # rule; the nearest-value endpoint fill above makes plain one-sided secant
    # adequate for gap-filling parity at 1e-6 level on the filled ends.
    pc = jnp.clip(prev, 0, n - 1)
    nc = jnp.clip(nxt, 0, n - 1)
    # previous valid strictly before i / next strictly after i, per valid i
    prev_excl = jnp.concatenate([jnp.full_like(prev[..., :1], -1), prev[..., :-1]], -1)
    next_excl = jnp.concatenate([nxt[..., 1:], jnp.full_like(nxt[..., :1], n)], -1)
    pe = jnp.clip(prev_excl, 0, n - 1)
    ne = jnp.clip(next_excl, 0, n - 1)
    h1 = jnp.maximum(idx - pe, 1)
    h2 = jnp.maximum(ne - idx, 1)
    d1 = (xz2 - _gather_last(xz2, pe)) / h1
    d2 = (_gather_last(xz2, ne) - xz2) / h2
    w1 = 2 * h2 + h1
    w2 = h2 + 2 * h1
    same_sign = (d1 * d2) > 0
    m_interior = jnp.where(same_sign, (w1 + w2) / (w1 / jnp.where(d1 == 0, 1, d1) + w2 / jnp.where(d2 == 0, 1, d2)), 0.0)
    m = jnp.where(prev_excl < 0, d2, jnp.where(next_excl >= n, d1, m_interior))
    # Hermite evaluation on each gap between pc(nan) and nc(nan)
    xa = _gather_last(xz2, pc)
    xb = _gather_last(xz2, nc)
    ma = _gather_last(m, pc)
    mb = _gather_last(m, nc)
    h = jnp.maximum(nc - pc, 1)
    t = (idx - pc) / h
    t2, t3 = t * t, t * t * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    val = h00 * xa + h10 * h * ma + h01 * xb + h11 * h * mb
    return jnp.where(valid2, x2, val)
