"""Device-side polyphase resampling (rational rate change as a convolution).

SURVEY.md §7 hard-part 5 calls out resampling as a pipeline bottleneck:
the reference resamples every file on the host through librosa.load
(script/mfcc.py:373). The corpus driver already does host decode+resample
in C++ worker threads (io/native.py), but stages that need a SECOND rate
device-side — formant tracking resamples to 2x the formant ceiling
(Praat's first step, script/calc.py:131-141) — would otherwise round-trip
to the host. This module keeps that entirely on device.

Formulation: the textbook polyphase identity. For a rational
up/down change with FIR taps ``h`` (odd length K, centered), output phase
``p`` of every output block is one strided correlation of the INPUT —
no zero-stuffed upsampled signal ever exists:

    y[up·t + p] = up · Σ_r h[p·down + c − up·r] · x[down·t + r],  c=(K−1)//2

which maps to ONE ``conv_general_dilated`` with ``up`` output channels
(one per phase), stride ``down``, kernel width ~K/up — an im2col matmul
one GEMM-shaped op — followed by a phase-interleave reshape. Matches scipy's
``resample_poly`` (the host path in io/wav.py, same kaiser_best-grade
taps) to float32 rounding; tests/test_ops_misc.py pins it.
"""
from __future__ import annotations

from fractions import Fraction
from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from modulation_mfcc.io.wav import design_hq_taps

__all__ = ["resample_poly_device", "resample_device", "n_resampled"]


def n_resampled(n: int, up: int, down: int) -> int:
    """scipy resample_poly output length: ceil(n·up/down)."""
    return -(-n * up // down)


@lru_cache(maxsize=16)
def _phase_kernel(up: int, down: int):
    """(kernel [up, 1, W], r_lo) — per-phase tap matrix for the strided conv."""
    h = design_hq_taps(up, down)  # [K], no up gain
    K = len(h)
    c = (K - 1) // 2
    r_lo = int(np.ceil((c - K + 1) / up))  # widest support over p=0
    r_hi = int(np.floor(((up - 1) * down + c) / up))
    W = r_hi - r_lo + 1
    kern = np.zeros((up, 1, W), dtype=np.float64)
    for p in range(up):
        for w in range(W):
            idx = p * down + c - up * (r_lo + w)
            if 0 <= idx < K:
                kern[p, 0, w] = up * h[idx]
    return kern, r_lo, r_hi


def resample_poly_device(
    x: jnp.ndarray, up: int, down: int, *, block_rows: int = 8192,
    block_threshold: int = 1 << 22,
) -> jnp.ndarray:
    """resample_poly(x, up, down) along the last axis, on device.

    x: [..., n] → [..., ceil(n·up/down)]; float32 in/out, HIGHEST-precision
    conv so the result matches the f64 host path to ~1e-6.

    Inputs with more than ``block_threshold`` TOTAL elements (batch ×
    length — XLA's staging scales with the whole conv, not one row) go
    through a BLOCKED conv: the
    flat ``[*, 1, n]`` form leaves XLA free to stage a ``[.., t_cnt·up, 1]``
    intermediate whose size-1 trailing axis a tiled layout pads 128× (an
    out-of-memory on the 1-hour 48 kHz longform input). Framing the
    signal into ``block_rows`` overlapping rows (gather-free shifted
    slices, ops/framing.py) batches the same conv over rows with sane
    tilings; outputs are element-identical (each row covers a contiguous
    run of output positions, tail rows read explicit zero padding that the
    final slice drops)."""
    if up == down:
        return x
    *lead, n = x.shape
    kern_np, r_lo, r_hi = _phase_kernel(up, down)
    n_out = n_resampled(n, up, down)
    t_cnt = -(-n_out // up)  # conv output positions per phase
    pad_lo = -r_lo
    kern = jnp.asarray(kern_np, dtype=x.dtype)
    dn = ("NCH", "OIH", "NCH")
    prec = jax.lax.Precision.HIGHEST
    if x.size <= block_threshold:
        pad_hi = max(0, down * (t_cnt - 1) + r_hi - (n - 1))
        lhs = x.reshape(-1, 1, n)
        out = jax.lax.conv_general_dilated(
            lhs, kern, window_strides=(down,), padding=[(pad_lo, pad_hi)],
            dimension_numbers=dn, precision=prec,
        )  # [N, up, t_cnt]
        # interleave phases: y[up·t + p] = out[:, p, t]
        y = jnp.moveaxis(out, -2, -1).reshape(len(lhs), t_cnt * up)
        return y[..., :n_out].reshape(*lead, n_out)
    from modulation_mfcc.ops.framing import frame_by_slices

    wk = kern_np.shape[-1]
    # conv outputs per row: block_rows-ish rows, but never so few outputs
    # per row that the W-sample halo dominates (≤ ~25% overlap) — a huge
    # batch of short signals crosses the size threshold with tiny t_cnt,
    # where per-output-rows would blow the input up W× instead of batching
    tc = min(t_cnt, max(-(-t_cnt // block_rows), -(-4 * wk // down)))
    nr = -(-t_cnt // tc)  # rows (nr·tc ≥ t_cnt)
    flen = down * (tc - 1) + wk
    hop = down * tc
    need = (nr - 1) * hop + flen  # padded-signal samples the rows read
    x1 = jnp.pad(
        x, [(0, 0)] * len(lead) + [(pad_lo, max(0, need - (n + pad_lo)))]
    )
    rows = frame_by_slices(x1, 0, nr, flen, hop)  # [..., nr, flen]
    out = jax.lax.conv_general_dilated(
        rows.reshape(-1, 1, flen), kern, window_strides=(down,),
        padding=[(0, 0)], dimension_numbers=dn, precision=prec,
    )  # [N·nr, up, tc]
    y = jnp.moveaxis(out, -2, -1).reshape(-1, nr * tc * up)
    return y[..., :n_out].reshape(*lead, n_out)


def resample_device(x: jnp.ndarray, orig_sr: float, target_sr: float) -> jnp.ndarray:
    """Rate-based wrapper mirroring io.wav.resample (same Fraction cap)."""
    if orig_sr == target_sr:
        return x
    frac = Fraction(int(round(target_sr)), int(round(orig_sr))).limit_denominator(1000)
    return resample_poly_device(x, frac.numerator, frac.denominator)
