"""Batched MFCC feature post-processing: deltas and normalization.

BASELINE.json config #2: "padded+masked MFCC + delta/delta-delta" with
"deltas and per-utterance normalization computed device-side".

  * ``delta`` — librosa.feature.delta semantics: Savitzky-Golay derivative
    (width 9, polyorder 1 by default, mode='interp') along the frame axis.
  * ``cmvn`` — per-utterance cepstral mean (and variance) normalization with
    frame masks, so padded batches normalize over valid frames only.
  * ``mfcc_with_deltas`` — [B, NF, 3*n_mfcc] stacked (static layout:
    coefficient axis last).
"""
from __future__ import annotations

import jax.numpy as jnp

from modulation_mfcc.ops.savgol import savgol_filter_jax

__all__ = ["delta", "cmvn", "mfcc_with_deltas"]


def delta(m: jnp.ndarray, *, width: int = 9, order: int = 1, axis: int = -2) -> jnp.ndarray:
    """librosa.feature.delta equivalent over the frame axis.

    m: [..., NF, n_mfcc] (frame axis default -2). librosa applies
    scipy.signal.savgol_filter(width, polyorder=order, deriv=order,
    mode='interp') — the same operator as ops/savgol.
    """
    moved = jnp.moveaxis(m, axis, -1)
    out = savgol_filter_jax(moved, width, order, deriv=order)
    return jnp.moveaxis(out, -1, axis)


def cmvn(
    m: jnp.ndarray,
    *,
    frame_mask: jnp.ndarray | None = None,
    variance: bool = True,
    eps: float = 1e-8,
) -> jnp.ndarray:
    """Per-utterance mean (and variance) normalization over valid frames.

    m: [..., NF, C]; frame_mask: [..., NF] (1=valid). Padded frames are
    zeroed in the output so downstream masked reductions stay clean.
    """
    if frame_mask is None:
        mu = jnp.mean(m, axis=-2, keepdims=True)
        if variance:
            sd = jnp.std(m, axis=-2, keepdims=True)
            return (m - mu) / (sd + eps)
        return m - mu
    w = frame_mask[..., :, None]
    n = jnp.maximum(jnp.sum(w, axis=-2, keepdims=True), 1.0)
    mu = jnp.sum(m * w, axis=-2, keepdims=True) / n
    out = (m - mu) * w
    if variance:
        var = jnp.sum((m - mu) ** 2 * w, axis=-2, keepdims=True) / n
        out = out / (jnp.sqrt(var) + eps)
    return out * w


def mfcc_with_deltas(
    m: jnp.ndarray,
    *,
    frame_mask: jnp.ndarray | None = None,
    width: int = 9,
    normalize: bool = False,
) -> jnp.ndarray:
    """[..., NF, 3*C]: static + delta + delta-delta (optionally CMVN'd)."""
    d1 = delta(m, width=width, order=1)
    d2 = delta(m, width=width, order=2)
    out = jnp.concatenate([m, d1, d2], axis=-1)
    if normalize:
        out = cmvn(out, frame_mask=frame_mask)
    elif frame_mask is not None:
        out = out * frame_mask[..., :, None]
    return out
