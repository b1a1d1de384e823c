"""Praat-style intensity (dB SPL) — pitch-floor-sized Kaiser-20 window.

Replaces the reference's ``call(sound, "To Intensity", minPitch, timeStep, 1)``
(script/mfcc.py:229-233, script/calc.py:156 via sound.to_intensity()):
windowed mean square of the mean-subtracted signal, expressed in dB re
2·10⁻⁵ Pa (auditory threshold). Praat semantics, matched frame-exactly to
the float64 oracle (oracle.praat_intensity_np — an independent rederivation
of Sound_to_Intensity):

- physical window 6.4/minPitch (2× the documented 3.2-period *effective*
  duration); default time step 0.8/minPitch ("four times oversampling");
- frame grid from Sampled_shortTermAnalysis (Sound x1 = dx/2): nf =
  floor((dur − winDur)/ts) + 1, first mid-time = dur/2 − (nf−1)·ts/2,
  mid SAMPLE = nearest index per frame — EXACT for every ts·sr: when
  ts·sr is an integer (every reference config) the grid is uniform and
  frames come from hop-strided slices; otherwise Praat's genuinely
  non-uniform nearest-index grid is reproduced via one [NF, nw] gather;
- taper w(i) = I₀((2π² + 0.5)·√(1 − (i/(halfDur·sr))²)) over the 2·hws+1
  samples around the mid sample, hws = floor(halfDur·sr) (sidelobes
  < −190 dB so F0 ripple stays below the dB floor);
- per-frame PLAIN mean over in-range samples subtracted before squaring,
  windowed mean square normalized by the in-range window sum (the masked
  path only compiles in when a frame actually touches a boundary — a
  static host-side check);
- dB = 10·log10(ms / 4e-10), −300 where ms < 1e-30.

Formulation: one framed weighted-square reduction — frames [NF, nw] ×
window → matvec — entirely fused by XLA.
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from modulation_mfcc.ops.framing import frame_by_slices

__all__ = ["intensity_db", "intensity_times"]

_HEARING_THRESHOLD_SQ = 4.0e-10  # (2e-5 Pa)^2


def _geometry(n: int, sr: float, min_pitch: float, time_step: float):
    """(hws, hop, nf, ts, first_time): Praat short-term-analysis grid.

    Every float expression here matches oracle.praat_intensity_np term for
    term (duration = n·dx with dx = 1/sr, not n/sr) so floors/ties resolve
    identically on both sides.
    """
    ts = 0.8 / min_pitch if time_step <= 0.0 else time_step
    dx = 1.0 / sr
    duration = n * dx
    window_dur = 6.4 / min_pitch
    hws = int(np.floor(3.2 / min_pitch * sr))
    if window_dur > duration:
        # Praat raises ("shorter than window length"); degrade to a
        # signal-sized window instead — a forgiving superset of the
        # oracle's domain. When the window merely OVERHANGS (2·hws+1 > n
        # but window_dur ≤ duration) keep Praat's hws: the masked path
        # clips per frame exactly like the oracle.
        hws = max((n - 1) // 2, 1)
    nf = max(1, int(np.floor((duration - window_dur) / ts)) + 1)
    first_time = 0.5 * duration - 0.5 * nf * ts + 0.5 * ts
    hop = max(1, int(round(ts * sr)))
    return hws, hop, nf, ts, first_time


def _kaiser20(hws: int, half_dur_samples: float) -> np.ndarray:
    from scipy.special import i0 as _bessel_i0

    i = np.arange(-hws, hws + 1, dtype=np.float64)
    root = 1.0 - (i / half_dur_samples) ** 2
    return np.where(
        root > 0.0,
        _bessel_i0((2.0 * np.pi**2 + 0.5) * np.sqrt(np.maximum(root, 0.0))),
        0.0,
    )


@partial(jax.jit, static_argnames=("sr", "min_pitch", "time_step"))
def intensity_db(
    x: jnp.ndarray, *, sr: float, min_pitch: float = 100.0, time_step: float = 0.0
) -> jnp.ndarray:
    """Intensity contour [NF] in dB for 1-D x (interpreted as Pascal)."""
    n = x.shape[-1]
    hws, hop, nf, ts, ft = _geometry(n, sr, min_pitch, time_step)
    nw = 2 * hws + 1
    w = _kaiser20(hws, 3.2 / min_pitch * sr)
    # pre-normalized (the masked path normalizes by valid@w, a ratio in
    # which the scale cancels); keeping the divisor out of the graph also
    # keeps the output dtype = x.dtype (a numpy f64 scalar would promote
    # under x64)
    wj = jnp.asarray(w / np.sum(w), dtype=x.dtype)
    # per-frame nearest mid samples, the SAME float expression as the
    # oracle (round-half-up with the epsilon tie guard) — host-side ints,
    # so grid irregularity costs nothing at trace time
    dx = 1.0 / sr
    mids = np.floor(
        (ft + np.arange(nf) * ts - 0.5 * dx) * sr + 0.5 + 1e-6
    ).astype(np.int64)
    starts = mids - hws
    uniform = bool(np.all(mids == mids[0] + np.arange(nf, dtype=np.int64) * hop))
    clips = starts[0] < 0 or starts[-1] + nw > n  # static
    # parity surface: the windowed-square matvec must not round operands
    # to a reduced-precision default (TF32 on the GPU)
    _hi = jax.lax.Precision.HIGHEST
    if uniform and not clips:
        frames = frame_by_slices(x, int(starts[0]), nf, nw, hop)
        d = frames - jnp.mean(frames, axis=-1, keepdims=True)
        ms = jnp.matmul(d * d, wj, precision=_hi)
    else:
        # Two rare cases share this masked path: (a) boundary frames (≤1
        # sample of overhang from nearest-index rounding) — Praat sums only
        # in-range samples, so the mean count, window normalization and the
        # squared sum all drop the out-of-range tap; zero-pad + mask
        # reproduces that exactly. (b) non-integer ts·sr (e.g. the auto
        # step 0.8/minPitch at an incommensurate rate): Praat's grid is
        # then genuinely non-uniform (nearest-index per frame), which a
        # uniform hop would drift away from linearly — frame via one
        # [NF, nw] gather instead (intensity runs once per file; every
        # benched/reference config has integer ts·sr and stays on the
        # fast path).
        xpad = jnp.pad(x, (hws, hws))
        # Non-integer ts·sr grids are still EXACTLY q-interleaved-uniform
        # when ts·sr is rational with a small denominator (the mid-sample
        # floor argument advances by the integer p every q frames), e.g.
        # Praat's auto step at min_pitch=75 @10 kHz: ts·sr = 320/3 → three
        # hop-320 grids. Frame each group with strided slices and
        # interleave the rows — no element gathers at [NF, nw] scale.
        q = None
        if not uniform:
            for cand in range(2, 17):
                if nf <= cand:
                    break
                step = int(mids[cand] - mids[0])
                if np.all(mids[cand:] - mids[:-cand] == step):
                    q = cand
                    break
        if uniform:
            frames = frame_by_slices(xpad, int(starts[0]) + hws, nf, nw, hop)
        elif q is not None:
            hopq = int(mids[q] - mids[0])
            groups = []
            for g in range(q):
                nfg = (nf - g + q - 1) // q  # frames g, g+q, g+2q, …
                groups.append(
                    frame_by_slices(xpad, int(starts[g]) + hws, nfg, nw, hopq)
                )
            m = groups[0].shape[0]  # group 0 is the largest
            groups = [
                jnp.pad(gr, ((0, m - gr.shape[0]), (0, 0))) for gr in groups
            ]
            frames = jnp.stack(groups, axis=1).reshape(m * q, nw)[:nf]
        else:
            frames = xpad[
                jnp.asarray(starts[:, None] + np.arange(nw)[None, :] + hws)
            ]
        idx = starts[:, None] + np.arange(nw, dtype=np.int64)[None, :]
        valid = jnp.asarray((idx >= 0) & (idx < n), dtype=x.dtype)
        cnt = jnp.sum(valid, axis=-1, keepdims=True)
        mean = jnp.sum(frames, axis=-1, keepdims=True) / cnt  # pads are 0
        d = (frames - mean) * valid
        ms = jnp.matmul(d * d, wj, precision=_hi) / jnp.matmul(
            valid, wj, precision=_hi
        )
    return jnp.where(
        ms < 1e-30,
        jnp.asarray(-300.0, x.dtype),
        10.0 * jnp.log10(jnp.maximum(ms, 1e-300) / _HEARING_THRESHOLD_SQ),
    )


def intensity_times(n: int, sr: float, min_pitch: float, time_step: float) -> np.ndarray:
    """Frame mid-times of :func:`intensity_db` (host-side, Praat nominal)."""
    _, _, nf, ts, first_time = _geometry(n, sr, min_pitch, time_step)
    return first_time + np.arange(nf) * ts
