"""Length-masked variants of the edge-sensitive ops.

Variable-length batching without parity drift (SURVEY.md §7 hard part #3):
zero-phase filters and derivative stencils reflect/fit around the *true* end
of each utterance, so a padded batch naively filtered along its static time
axis would differ from per-file results near every valid/invalid boundary.

These variants take a traced per-item valid length ``L`` and reproduce the
exact single-file edge behavior inside a static buffer:

  * the odd extension is built with clamped gathers whose reflection point is
    the dynamic ``L-1`` (not the padded end);
  * time reversal reverses only the valid prefix (gather with dynamic
    offset) — the IIR scans are causal, so junk beyond the prefix never
    propagates backward into valid samples;
  * gradient / Savitzky-Golay edge rows are rewritten at the dynamic
    boundary indices with `where` masks.

Everything stays static-shape and vmappable: per-utterance lengths are plain
traced scalars under `jax.vmap`, so one compiled program serves every length
in a bucket.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from modulation_mfcc.ops.filters import sosfilt, _lfilter_scan
from modulation_mfcc.ops.savgol import _savgol_design

__all__ = [
    "masked_odd_ext",
    "masked_reverse",
    "masked_sosfiltfilt",
    "masked_filtfilt",
    "masked_gradient",
    "masked_savgol",
]


def _shift_clamped(x: jnp.ndarray, s: int) -> jnp.ndarray:
    """x[..., clip(i + s, 0, t-1)] for STATIC s as slice + edge tile.

    Unlike the element-gather form of the same expression, this concat
    lowers to two plain copies."""
    t = x.shape[-1]
    if s == 0:
        return x
    if s > 0:
        s = min(s, t - 1)
        edge = jnp.broadcast_to(x[..., -1:], x.shape[:-1] + (s,))
        return jnp.concatenate([x[..., s:], edge], axis=-1)
    s = min(-s, t - 1)
    edge = jnp.broadcast_to(x[..., :1], x.shape[:-1] + (s,))
    return jnp.concatenate([edge, x[..., : t - s]], axis=-1)


def _dyn_window(x: jnp.ndarray, start, out_len: int) -> jnp.ndarray:
    """w[j] = x[..., start + j] for j in [0, out_len); ZERO where start+j
    falls outside [0, t). ``start`` is a traced scalar (may be negative).

    One dynamic_slice into a zero-padded buffer — under vmap this lowers
    to a per-row contiguous-block slice (DMA), not the per-element gather
    that jnp.take(clip(...)) produces."""
    t = x.shape[-1]
    z = jnp.zeros(x.shape[:-1] + (out_len,), x.dtype)
    buf = jnp.concatenate([z, x, z], axis=-1)
    s = jnp.clip(start + out_len, 0, t + out_len)
    starts = (jnp.zeros((), s.dtype),) * (x.ndim - 1) + (s,)
    return jax.lax.dynamic_slice(buf, starts, x.shape[:-1] + (out_len,))


def _rev_window(x: jnp.ndarray, c, out_len: int) -> jnp.ndarray:
    """r[j] = x[..., c - j] for j in [0, out_len); zero outside [0, t).
    ``c`` traced. Implemented as a static flip + :func:`_dyn_window`."""
    t = x.shape[-1]
    return _dyn_window(jnp.flip(x, axis=-1), t - 1 - c, out_len)


def masked_odd_ext(x: jnp.ndarray, length, padlen: int) -> jnp.ndarray:
    """Odd extension around [0, length) inside a static buffer.

    x: [..., T]; length: traced scalar. Returns [..., T + 2*padlen] whose
    first ``length + 2*padlen`` entries equal scipy's odd_ext of x[:length];
    the rest are zeros. Gather-free: the left reflection is a static flip,
    the middle is a pad, the right reflection is a flip + one dynamic
    slice (see _dyn_window). Assumes the scipy-valid regime
    ``padlen < length`` (scipy's filtfilt itself rejects shorter inputs);
    degenerate lengths read zeros where the old clamped gather read edge
    samples — both are outside the masked-output contract.
    """
    t = x.shape[-1]
    out_t = t + 2 * padlen
    j = jnp.arange(out_t) - padlen
    x0 = x[..., :1]
    xe = _dyn_window(x, jnp.clip(length - 1, 0, t - 1), 1)  # [..., 1]
    if padlen == 0:
        return jnp.where(j < length, x, 0.0)
    # left reflection x[padlen - m], m in [0, padlen): static flip
    npad = min(padlen, t - 1)
    lcore = jnp.flip(x[..., 1 : npad + 1], axis=-1)
    if npad < padlen:  # degenerate tiny buffer: clamp like the old gather
        edge = jnp.broadcast_to(x[..., -1:], x.shape[:-1] + (padlen - npad,))
        lcore = jnp.concatenate([edge, lcore], axis=-1)
    zl = jnp.zeros(x.shape[:-1] + (out_t - padlen,), x.dtype)
    left = 2.0 * x0 - jnp.concatenate([lcore, zl], axis=-1)
    mid = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(padlen, padlen)])
    # right reflection x[(2L-2+padlen) - m] over the whole output axis
    right = 2.0 * xe - _rev_window(x, 2 * length - 2 + padlen, out_t)
    vals = jnp.where(j < 0, left, jnp.where(j < length, mid, right))
    return jnp.where(j < length + padlen, vals, 0.0)


def masked_reverse(y: jnp.ndarray, ext_len) -> jnp.ndarray:
    """Reverse the valid prefix [0, ext_len) of y along the last axis.
    Gather-free: flip + one dynamic slice (zeros beyond the prefix)."""
    return _rev_window(y, ext_len - 1, y.shape[-1])


def masked_sosfiltfilt(
    sos: np.ndarray, zi: np.ndarray, padlen: int, x: jnp.ndarray, length
) -> jnp.ndarray:
    """sosfiltfilt of x[..., :length] inside the static buffer [..., T].

    Output positions >= length are unspecified (masked downstream). The
    forward/backward passes are full-buffer causal scans; correctness of the
    valid region follows from causality + valid-prefix reversal.
    """
    t = x.shape[-1]
    ext = masked_odd_ext(x, length, padlen)
    zi_b = np.asarray(zi)
    zi_c = jnp.asarray(zi_b).reshape((zi_b.shape[0],) + (1,) * (x.ndim - 1) + (2,))
    y = sosfilt(sos, ext, zi=zi_c * ext[..., :1])
    ext_len = length + 2 * padlen
    yr = masked_reverse(y, ext_len)
    y2 = sosfilt(sos, yr, zi=zi_c * yr[..., :1])
    y3 = masked_reverse(y2, ext_len)
    return y3[..., padlen : padlen + t]


def masked_filtfilt(
    b: np.ndarray, a: np.ndarray, zi: np.ndarray, padlen: int, x: jnp.ndarray, length
) -> jnp.ndarray:
    """filtfilt (transversal, e.g. FIR) of x[..., :length] in a static buffer."""
    t = x.shape[-1]
    ext = masked_odd_ext(x, length, padlen)
    zi_j = jnp.asarray(zi, dtype=x.dtype)
    zi_full = jnp.broadcast_to(zi_j, ext.shape[:-1] + zi_j.shape)
    y, _ = _lfilter_scan(b, a, ext, zi_full * ext[..., :1])
    ext_len = length + 2 * padlen
    yr = masked_reverse(y, ext_len)
    y2, _ = _lfilter_scan(b, a, yr, zi_full * yr[..., :1])
    y3 = masked_reverse(y2, ext_len)
    return y3[..., padlen : padlen + t]


def masked_sosfiltfilt_fir(design, x: jnp.ndarray, length) -> jnp.ndarray:
    """FIR-operator sosfiltfilt of x[..., :length] in a static buffer.

    Same operator as filters.sosfiltfilt_fir (probed kernel + edge blocks)
    with the right edge anchored at the dynamic ``length``:

      y[i] = left_edge          for i <  E
      y[i] = conv interior      for E <= i < length - E   (reads x[< length])
      y[i] = right_edge rows    for length - E <= i < length

    Caller contract: ``length >= design.min_len`` for every valid item (the
    bucketed batch layers guarantee this; shorter items must use the scan
    variant).
    """
    from modulation_mfcc.ops.filters import _conv_valid_lastaxis

    t = x.shape[-1]
    k, e, w = design.K, design.E, design.W
    i = jnp.arange(t)
    interior_full = _conv_valid_lastaxis(x, design.kernel)  # y[K .. t-K)
    pad_cfg = [(0, 0)] * (x.ndim - 1) + [(k, k)]
    interior = jnp.pad(interior_full, pad_cfg)  # aligned: interior[i] ~ y[i]
    hi = jax.lax.Precision.HIGHEST
    left = jnp.matmul(x[..., :w], jnp.asarray(design.left.T, dtype=x.dtype), precision=hi)
    # last valid window as ONE dynamic slice (length >= min_len >= w by the
    # caller contract), not a clipped element gather
    lastwin = _dyn_window(x, jnp.clip(length - w, 0, t - 1), w)
    right = jnp.matmul(lastwin, jnp.asarray(design.right.T, dtype=x.dtype), precision=hi)
    # y[i] for i in [length-E, length) = right[i - (length-E)]: align the E
    # edge rows to the output axis with one dynamic slice (zeros outside
    # the selected region, which the where below never reads)
    right_full = _dyn_window(right, e - length, t)
    left_full = jnp.concatenate(
        [left, jnp.zeros(left.shape[:-1] + (t - e,), left.dtype)], axis=-1
    )
    out = jnp.where(
        i < e,
        left_full,
        jnp.where(i < length - e, interior, right_full),
    )
    return jnp.where(i < length, out, 0.0)


def masked_gradient(x: jnp.ndarray, length, spacing: float = 1.0) -> jnp.ndarray:
    """np.gradient (edge_order=1) of x[..., :length] in a static buffer."""
    t = x.shape[-1]
    i = jnp.arange(t)
    xp = _shift_clamped(x, -1)
    xn = _shift_clamped(x, 1)
    central = (xn - xp) / (2.0 * spacing)
    left = (x[..., 1:2] - x[..., :1]) / spacing
    xl1 = _dyn_window(x, jnp.clip(length - 1, 0, t - 1), 1)
    xl2 = _dyn_window(x, jnp.clip(length - 2, 0, t - 1), 1)
    right = (xl1 - xl2) / spacing
    out = jnp.where(i == 0, left, jnp.where(i == length - 1, right, central))
    return jnp.where(i < length, out, 0.0)


def masked_savgol(
    x: jnp.ndarray,
    window_length: int,
    polyorder: int,
    length,
    *,
    deriv: int = 0,
    delta: float = 1.0,
) -> jnp.ndarray:
    """savgol_filter(mode='interp') of x[..., :length] in a static buffer."""
    t = x.shape[-1]
    coeffs, edge_op = _savgol_design(window_length, polyorder, deriv, float(delta))
    half = window_length // 2
    i = jnp.arange(t)
    # interior: scipy applies convolve1d(x, coeffs) which flips the kernel —
    # as correlation: out[i] = Σ_j c[w-1-j] · x[i-half+j]
    acc = jnp.zeros_like(x)
    for j, c in enumerate(np.asarray(coeffs)[::-1]):
        acc = acc + float(c) * _shift_clamped(x, j - half)
    # left edge rows: E_left @ x[:w]
    e = np.asarray(edge_op)
    hi = jax.lax.Precision.HIGHEST  # scipy-parity edge blocks, bf16-proof
    left = jnp.matmul(
        x[..., :window_length], jnp.asarray(e[:half].T, dtype=x.dtype),
        precision=hi,
    )
    # right edge rows: E_right @ x[L-w : L]
    lastwin = _dyn_window(
        x, jnp.clip(length - window_length, 0, t - 1), window_length
    )
    right = jnp.matmul(
        lastwin, jnp.asarray(e[window_length - half :].T, dtype=x.dtype),
        precision=hi,
    )
    out = acc
    for r in range(half):
        out = jnp.where(i == r, left[..., r : r + 1], out)
        out = jnp.where(i == length - half + r, right[..., r : r + 1], out)
    return jnp.where(i < length, out, 0.0)
