"""Autocorrelation pitch tracking (Boersma 1993) with on-device Viterbi.

Device-side replacement for the reference's Praat calls
(script/calc.py:535-560: ``To Pitch (ac)`` / ``To Pitch (cc)`` with the full
cost-parameter surface). parselmouth links Praat's C++; here the same
published algorithm is expressed as batched static-shape JAX:

  frames → mean-subtract → window → rFFT autocorrelation, normalized by the
  window's own autocorrelation (the 'ac' estimator) or frame-to-frame cross
  correlation ('cc') → top-K local maxima with parabolic refinement →
  candidate strengths with octave cost + silence/voicing thresholds →
  Viterbi path over (maxCandNum) candidates per frame via `lax.scan`.

Design notes (vs Praat's implementation):
  * every frame is processed in parallel (one big [NF, nfft] rFFT batch)
    instead of Praat's per-frame loop;
  * candidate extraction is `top_k` over masked local-maxima strengths —
    fixed candidate count, no dynamic shapes;
  * the path finder is a dense [K]→[K] Viterbi relaxation scanned over
    frames — K=15 keeps the transition matrix tiny;
  * candidate lags are refined by maximizing the windowed-sinc
    interpolation of r(τ) (Praat's NUMimproveMaximum + sinc scheme),
    evaluated DENSELY for every lag as one slice-built-window × weight
    matmul + parabolic polish (_refine_sinc_dense) — no data-dependent
    gathers (Praat uses Brent per candidate);
  * ``very_accurate`` follows Praat's To Pitch veryAccurate flag
    (script/calc.py:545): for 'ac' the window doubles to 6 periods with the
    Gaussian taper (exp(-48·u²) edge-normalized) and the sinc interpolation
    support deepens (Praat: sinc70 → sinc700; here 35 → 70 taps per side,
    past which the smooth autocorrelation's interpolant is converged).

Cost conventions follow Praat: transition costs are defined per 0.01 s and
scaled by ``0.01 / timeStep``; strengths use
``R' = r - octaveCost·log2(minPitch·τ)`` and the unvoiced strength
``voicingThreshold + max(0, 2 - (localPeak/globalPeak)/(silenceThresh/(1+voicingThresh)))``.
"""
from __future__ import annotations

from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp

from modulation_mfcc.ops.framing import frame_by_slices
from modulation_mfcc.utils.helpers import next_pow2

__all__ = ["pitch_ac", "PitchParams"]


def _frame_centered(x: jnp.ndarray, starts: np.ndarray, nw: int) -> jnp.ndarray:
    # regular grid → slice-built frames (no gather; see ops/framing.py)
    hop = int(starts[1] - starts[0]) if len(starts) > 1 else 1
    return frame_by_slices(x, int(starts[0]), len(starts), nw, hop)


def _dft_mats(n_in: int, nfft: int, n_lags: int, dtype, want_sin: bool = False):
    """Host-built real-DFT matrices shared by the 'ac' and 'cc' matmul paths.

    Returns ``(kbins, cs, ct, st)``: the forward projection ``cs``
    [n_in, 2K] (cos | sin columns, X[k] = proj_c − i·proj_s), and the
    inverse-transform matmuls ``ct``/``st`` [K, n_lags] carrying the
    half-spectrum weights w_k/nfft (DC and, for even nfft, Nyquist at 1) —
    so ``irfft(C)[τ] = Re(C) @ ct − Im(C) @ st``. ``st`` is None unless
    requested (the autocorrelation's spectrum is real)."""
    kbins = nfft // 2 + 1
    ii = np.arange(n_in, dtype=np.float64)
    kk = np.arange(kbins, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(ii, kk) / nfft
    cs = jnp.asarray(np.concatenate([np.cos(ang), np.sin(ang)], axis=1), dtype=dtype)
    wk = np.full(kbins, 2.0)
    wk[0] = 1.0
    if nfft % 2 == 0:
        wk[-1] = 1.0
    angt = 2.0 * np.pi * np.outer(kk, np.arange(n_lags, dtype=np.float64)) / nfft
    ct = jnp.asarray(np.cos(angt) * wk[:, None] / nfft, dtype=dtype)
    st = jnp.asarray(np.sin(angt) * wk[:, None] / nfft, dtype=dtype) if want_sin else None
    return kbins, cs, ct, st


def _dot(a, b):
    """Batched [..., n] @ [n, m] at HIGHEST precision (parity grade)."""
    return jax.lax.dot_general(
        a, b, (((a.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )


def _sinc_weights(offsets: np.ndarray, depth: int) -> np.ndarray:
    """Interpolation weight matrix [2·depth+3, n_offsets] for evaluating the
    windowed-sinc interpolant (sinc × raised-cosine taper over ±depth
    samples, Praat's NUM_interpolate_sinc scheme) at fractional ``offsets``
    relative to an integer grid point, using the support samples at
    integer positions −(depth+1) … +(depth+1) around it (host-side, f64).

    Known deviation from Praat (kept deliberately): Praat anchors the taper
    window at floor(pos), so crossing an integer shifts the support set by
    one sample; here the support is the fixed ±(depth+1) neighborhood of the
    nearest grid point with the raised cosine zeroed past ±(depth+1) of the
    evaluation point. The fixed window is smoother at integer crossings and
    agrees with Praat's interpolant far below tracker tolerance (the
    Praat-parity tolerance tests — not the self-pinned goldens — are the
    correctness bar for this choice)."""
    k = np.arange(-(depth + 1), depth + 2, dtype=np.float64)  # [2d+3]
    dist = offsets[None, :] - k[:, None]  # [2d+3, G]
    w = np.sinc(dist) * (0.5 + 0.5 * np.cos(np.pi * dist / (depth + 1)))
    # taper support is ±(depth+1) around the *evaluation point*; samples
    # farther than that contribute nothing (the raised cosine has a zero
    # exactly at |dist| = depth+1)
    w[np.abs(dist) > depth + 1] = 0.0
    return w


@lru_cache(maxsize=8)
def _sinc_band_matrix(grid: int, depth: int, nl: int) -> np.ndarray:
    """Banded-GEMM operator [nl+S-1, grid·nl] for _refine_sinc_dense:
    column g·nl+l carries the sinc weight column w[:, g] on input rows
    l … l+S-1 (host-side f64)."""
    w = _sinc_weights(np.linspace(-1.0, 1.0, grid), depth)  # [S, G]
    s = w.shape[0]
    band = np.zeros((nl + s - 1, grid * nl), np.float64)
    for l in range(nl):
        band[l : l + s, np.arange(grid) * nl + l] = w
    return band


def _refine_sinc_dense(
    r_ext: jnp.ndarray,
    ext_left: int,
    lag_max: int,
    depth: int,
    grid: int = 17,
    lag_lo: int = 0,
):
    """Windowed-sinc peak refinement of ``r_ext`` [..., L] for EVERY integer
    lag lag_lo…lag_max at once: ``(pos_l, val_l)`` [..., lag_max−lag_lo+1] give, for
    each lag ``l``, the position (in absolute lag samples) and value of the
    interpolant's maximum inside (l−1, l+1). Callers read off the entries
    at their candidate lags (a tiny element gather over K·NF values).

    Per-candidate gathers of the sinc support (element or row gathers)
    dominated the whole tracker in earlier forms. Dense evaluation has NO
    data-dependent access: the interpolant at every (lag, offset) pair is
    ONE matmul against precomputed weights, and the argmax + parabolic
    polish are elementwise — faster despite refining ~10× more lags than
    the candidate set needs. Grid spacing 2/(grid−1) = 1/8 at the default
    grid=17 with the parabolic correction lands within ~4e-3 samples of
    the continuous interpolant peak (parabolic error ~h², ≈ milli-Hz-grade
    f0 — verified 0.0016 Hz max vs the float64 Boersma oracle), matching
    Praat's Brent refinement to far below the tracker's own tolerance."""
    offs = np.linspace(-1.0, 1.0, grid)
    S = 2 * depth + 3
    nl = lag_max - lag_lo + 1
    # The interpolant at every (lag, offset) pair is a 1-D correlation of
    # r_ext along the lag axis with the G weight rows: out[..., g, l] =
    # Σ_s r_ext[..., start + l + s]·w[s, g]. Expressed as ONE banded GEMM
    # — x [.., nl+S-1] @ Wband [nl+S-1, G·nl] with Wband[c, g·nl+l] =
    # w[c-l, g] on the band 0 ≤ c-l < S — one large matmul, and the
    # [.., G, nl] layout falls out of a reshape. (A conv_general_dilated
    # form and an explicit [..., nl, S] windows tensor were both slower.)
    lead = r_ext.shape[:-1]
    start = ext_left - (depth + 1) + lag_lo
    x = jax.lax.slice_in_dim(r_ext, start, start + nl + S - 1, axis=-1)
    wband = jnp.asarray(
        _sinc_band_matrix(grid, depth, nl), dtype=r_ext.dtype
    )  # [nl+S-1, G·nl]
    interp = jnp.dot(x, wband, precision=jax.lax.Precision.HIGHEST).reshape(
        *lead, grid, nl
    )  # [..., G, nl]
    # interior argmax over the offset grid (offsets ±1 are the neighboring
    # integer samples — each lag is refined as if it were a discrete local
    # max, so the parabola always has both neighbors)
    imax = jnp.argmax(interp[..., 1:-1, :], axis=-2) + 1  # [..., nl]
    # neighbor extraction WITHOUT take_along_axis: three shifted one-hot
    # masks, fused by XLA into a single traversal of interp
    g = jnp.arange(grid)
    oh = (g[:, None] == imax[..., None, :]).astype(interp.dtype)  # [..., G, nl]
    f0 = jnp.sum(interp * oh, axis=-2)
    fm = jnp.sum(
        jax.lax.slice_in_dim(interp, 0, -1, axis=-2) * oh[..., 1:, :], axis=-2
    )
    fp = jnp.sum(
        jax.lax.slice_in_dim(interp, 1, None, axis=-2) * oh[..., :-1, :], axis=-2
    )
    denom = fm - 2.0 * f0 + fp
    delta = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (fm - fp) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    h = float(offs[1] - offs[0])  # python float: no f64 promotion under x64
    lag_grid = jnp.arange(lag_lo, lag_lo + nl, dtype=r_ext.dtype)
    off_at_max = jnp.sum(
        oh * jnp.asarray(offs, dtype=r_ext.dtype)[:, None], axis=-2
    )
    pos = lag_grid + off_at_max + delta * h
    val = f0 - 0.25 * (fm - fp) * delta
    return pos, val


@partial(
    jax.jit,
    static_argnames=(
        "sr",
        "hop",
        "min_pitch",
        "max_pitch",
        "max_cand",
        "method",
        "silence_thresh",
        "voicing_thresh",
        "octave_cost",
        "octave_jump_cost",
        "voiced_unvoiced_cost",
        "periods_per_window",
        "very_accurate",
        "ac_engine",
    ),
)
def _pitch_ac_jit(
    x: jnp.ndarray,
    *,
    sr: float,
    hop: float = 0.01,
    min_pitch: float = 75.0,
    max_pitch: float = 600.0,
    max_cand: int = 15,
    method: str = "ac",
    silence_thresh: float = 0.03,
    voicing_thresh: float = 0.45,
    octave_cost: float = 0.01,
    octave_jump_cost: float = 0.35,
    voiced_unvoiced_cost: float = 0.14,
    periods_per_window: float = 3.0,
    very_accurate: bool = False,
    ac_engine: str = "auto",
    valid_len=None,
) -> jnp.ndarray:
    """F0 track [NF] in Hz (0 where unvoiced) for a 1-D signal.

    ``method='ac'`` uses a 3-period window with window-autocorrelation
    normalization (Praat's To Pitch (ac) estimator); ``method='cc'`` uses a
    1-period window and plain normalized cross-correlation.
    ``very_accurate`` doubles the 'ac' window (Gaussian taper) and deepens
    the sinc lag refinement, following Praat's veryAccurate flag.

    ``ac_engine``: 'auto' (= 'fft'), 'fft' (batched rFFT
    autocorrelation), or 'matmul' (real-DFT matmul autocorrelation at
    HIGHEST precision). The two compute the same zero-padded autocorrelation; they
    differ only in float reduction order (f0 deltas ~1e-3 Hz, tested).
    """
    if method == "cc":
        periods_per_window = 1.0
    elif very_accurate:
        periods_per_window *= 2.0  # Praat AC_GAUSS: 3 → 6 periods
    depth = 70 if very_accurate else 35  # sinc support per side
    n = x.shape[-1]
    dt = hop
    nw = int(round(periods_per_window / min_pitch * sr))
    nw = min(nw, n)
    hop_s = int(round(dt * sr))
    # lag search range
    lag_min = max(2, int(np.floor(sr / max_pitch)))
    lag_max = min(n - 1, int(np.ceil(sr / min_pitch)))
    if method == "ac":
        lag_max = min(lag_max, nw - 1)
    if lag_max <= lag_min:
        raise ValueError("max_pitch/min_pitch incompatible with window length")
    span = nw + (lag_max if method == "cc" else 0)
    nf = max(1, 1 + (n - span) // hop_s)
    # Praat centers the frame grid on the signal midpoint (its t1 places the
    # leftover samples symmetrically); the published time axis still follows
    # the reference's arange(nf)*hopSize convention (script/calc.py:560).
    start0 = max(0, (n - span - (nf - 1) * hop_s) // 2)
    starts = (start0 + np.arange(nf) * hop_s).astype(np.int32)
    # for 'ac', real (alias-free) r values are needed out to lag_max+depth+2
    # as the sinc interpolation's right-side support
    lag_hi = lag_max + depth + 2 if method == "ac" else lag_max
    nfft = next_pow2(int(span + lag_hi))

    # valid_len (traced, optional): true sample count when x is a padded
    # buffer — keeps the global mean/peak per-utterance in batched use
    if valid_len is None:
        xg = x - jnp.mean(x)
        global_peak = jnp.max(jnp.abs(xg)) + 1e-30
    else:
        in_sig = jnp.arange(n) < valid_len
        mean = jnp.sum(jnp.where(in_sig, x, 0.0)) / jnp.maximum(valid_len, 1)
        xg = jnp.where(in_sig, x - mean, 0.0)
        global_peak = jnp.max(jnp.abs(xg)) + 1e-30

    if n < span:
        # clip shorter than one analysis span ('cc' spans ~2 periods of
        # min_pitch): zero-extend so the single frame exists — the frame's
        # tail reads silence and the clip decodes unvoiced, instead of
        # frame_by_slices rejecting the out-of-range read
        xg = jnp.pad(xg, [(0, 0)] * (xg.ndim - 1) + [(0, span - n)])
    frames = _frame_centered(xg, starts, span)  # [NF, span]
    # Praat's local mean looks one longest period to both sides of the frame
    # midpoint (2·nsamp_period samples), for both estimators
    nsamp_period = max(1, int(np.floor(sr / min_pitch)))
    mid = span // 2
    mlo, mhi = max(0, mid - nsamp_period), min(span, mid + nsamp_period)
    local_mean = jnp.mean(frames[..., mlo:mhi], axis=-1, keepdims=True)
    fr = frames - local_mean
    local_peak = jnp.max(jnp.abs(fr[..., :nw]), axis=-1) + 1e-30

    if method == "ac":
        # windowed autocorrelation normalized by the window's own
        # autocorrelation (Boersma's 'ac' estimator)
        if very_accurate:
            # Praat AC_GAUSS taper (shared design, ops/windows.praat_gauss)
            from modulation_mfcc.ops.windows import praat_gauss

            w_np = praat_gauss(nw)
        else:
            # Praat AC_HANNING: w(i) = 0.5 − 0.5·cos(2πi/(n+1)), i = 1..n —
            # nonzero endpoints (scipy's symmetric Hann of n+2 with the zero
            # endpoints dropped), NOT scipy.hann(n)
            i = np.arange(1, nw + 1, dtype=np.float64)
            w_np = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (nw + 1))
        w = jnp.asarray(w_np, dtype=x.dtype)
        fw = fr * w
        if ac_engine == "matmul":
            # real-DFT autocorrelation: power spectrum as one
            # [NF, nw] x [nw, 2K] matmul, then the inverse transform
            # restricted to the lag_hi+1 lags actually needed as a second
            # [NF, K] x [K, lag_hi+1] cosine matmul. Mathematically equal
            # to rfft->|.|^2->irfft (same nfft zero-padding).
            kbins, cs, ctj, _ = _dft_mats(nw, nfft, lag_hi + 1, x.dtype)
            proj = _dot(fw, cs)
            power = proj[..., :kbins] ** 2 + proj[..., kbins:] ** 2
            ac = _dot(power, ctj)
            # window autocorrelation: same construction host-side in f64
            wf = np.fft.rfft(w_np, n=nfft)
            wac = np.fft.irfft(wf * np.conj(wf), n=nfft)[: lag_hi + 1]
        else:
            spec = jnp.fft.rfft(fw, n=nfft, axis=-1)
            ac = jnp.fft.irfft(spec * jnp.conj(spec), n=nfft, axis=-1)[..., : lag_hi + 1]
            wspec = jnp.fft.rfft(w, n=nfft)
            wacj = jnp.fft.irfft(wspec * jnp.conj(wspec), n=nfft)[: lag_hi + 1]
            wac = None
        r_full = ac / (ac[..., :1] + 1e-30)
        if wac is not None:
            rw = jnp.asarray(wac / (wac[0] + 1e-30), dtype=x.dtype)
        else:
            rw = wacj / (wacj[0] + 1e-30)
        r_full = r_full / jnp.maximum(rw, 1e-6)
        r = r_full[..., : lag_max + 1]
    else:
        # forward normalized cross-correlation ('cc'): the 1-period window
        # against its lag-shifted copy, energy-normalized per lag
        base = fr[..., :nw]
        if ac_engine == "matmul":
            # same real-DFT matmul scheme as the 'ac' branch (shared matrices
            # from _dft_mats), applied to the cross-spectrum conj(B)·F:
            # Re = bc·fc + bs·fs, Im = bs·fc − bc·fs, inverse = Re@ct − Im@st
            kbins, cs, ctj, stj = _dft_mats(
                span, nfft, lag_max + 1, x.dtype, want_sin=True
            )
            pf = _dot(fr, cs)
            pb = _dot(base, cs[:nw])
            fc, fs = pf[..., :kbins], pf[..., kbins:]
            bc, bs = pb[..., :kbins], pb[..., kbins:]
            re = bc * fc + bs * fs
            im = bs * fc - bc * fs
            cross = _dot(re, ctj) - _dot(im, stj)
        else:
            spec_full = jnp.fft.rfft(fr, n=nfft, axis=-1)
            spec_base = jnp.fft.rfft(base, n=nfft, axis=-1)
            cross = jnp.fft.irfft(jnp.conj(spec_base) * spec_full, n=nfft, axis=-1)[
                ..., : lag_max + 1
            ]
        csum = jnp.cumsum(fr * fr, axis=-1)
        total = jnp.concatenate([jnp.zeros_like(csum[..., :1]), csum], axis=-1)
        # consecutive indices -> contiguous slices, not gathers
        e_tau = jax.lax.slice_in_dim(total, nw, nw + lag_max + 1, axis=-1) - jax.lax.slice_in_dim(
            total, 0, lag_max + 1, axis=-1
        )
        e0 = e_tau[..., :1]
        r = cross / jnp.sqrt(jnp.maximum(e0 * e_tau, 1e-30))
        # sinc support past lag_max: edge-replicated (the cc energies are
        # only defined inside the frame span; candidates live well inside)
        r_full = jnp.pad(r, ((0, 0), (0, depth + 2)), mode="edge")

    lags = jnp.arange(lag_max + 1)
    in_range = (lags >= lag_min) & (lags <= lag_max)
    # True right neighbor AT the band edge (round-5 creaky-register fix):
    # Praat registers a maximum at lag_max only when r truly FALLS there
    # (oracle.py:506 reads r[lag_max+1]); a −inf pad fabricated an edge
    # candidate whenever r was still RISING — i.e. exactly when the real
    # peak lies beyond the band because f0 sits below the floor. Measured:
    # the creaky-offset fixture decoded 6 frames voiced at sr/lag_max
    # (79.4 Hz < the 80.1 Hz floor) where the oracle is unvoiced.
    if method == "ac":
        r_edge = r_full[..., lag_max + 1]
    else:
        # cc: the shifted window at lag_max+1 needs ONE sample past the
        # frame span — read it per frame with a strided slice (starts are
        # a static grid) and zero it where it leaves the signal, exactly
        # like the oracle's zero-filled shifted windows.
        xgp = jnp.pad(xg, [(0, 0)] * (xg.ndim - 1) + [(0, 1)])
        lim = start0 + span + (nf - 1) * hop_s + 1
        ext_raw = jax.lax.slice_in_dim(
            xgp, start0 + span, lim, stride=hop_s, axis=-1
        )  # [NF]
        idx_ext = jnp.asarray(start0 + span + np.arange(nf) * hop_s)
        lim_n = valid_len if valid_len is not None else n
        ext_adj = jnp.where(idx_ext < lim_n, ext_raw - local_mean[..., 0], 0.0)
        cross_e = (
            jnp.sum(base[..., : nw - 1] * fr[..., lag_max + 1 :], axis=-1)
            + base[..., -1] * ext_adj
        )
        e_ext = (total[..., -1] - total[..., lag_max + 1]) + ext_adj**2
        r_edge = cross_e / jnp.sqrt(jnp.maximum(e_tau[..., 0] * e_ext, 1e-30))
    # local maxima of r over lag
    rm = jnp.pad(r, ((0, 0), (1, 1)), constant_values=-jnp.inf)
    r_right = jnp.concatenate([r[..., 1:], r_edge[..., None]], axis=-1)
    is_max = (r > rm[..., :-2]) & (r >= r_right) & in_range[None, :]

    # parabolic refinement for the candidate SELECTION score (cheap over all
    # lags); the selected candidates get the full sinc refinement below
    # (rn uses the true band-edge neighbor too — the old roll wrapped r[0]
    # into the lag_max slot)
    rp = jnp.roll(r, 1, axis=-1)
    rn = r_right
    denom = rp - 2 * r + rn
    delta = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (rp - rn) / denom, 0.0)
    delta = jnp.clip(delta, -0.5, 0.5)
    lag_par = lags[None, :] + delta
    val_par = r - 0.25 * (rp - rn) * delta

    tau_par = lag_par / sr
    # Praat reflects correlation values above 1 ("high values due to short
    # windows") before using them as strengths: r > 1 → 1/r
    val_par = jnp.where(val_par > 1.0, 1.0 / jnp.maximum(val_par, 1e-12), val_par)
    sel_score = val_par - octave_cost * jnp.log2(jnp.maximum(min_pitch * tau_par, 1e-12))
    cand_score = jnp.where(is_max, sel_score, -jnp.inf)

    k = max_cand - 1  # one slot reserved for unvoiced
    # Candidate selection WITHOUT lax.top_k: the slots are only ever
    # consumed as one-hot masks (the readoffs below), so extract the k
    # best maxima iteratively — k fused passes of (masked max, first-
    # occurrence one-hot via min-of-iota) over the [NF, L] band — instead
    # of paying a 119-wide per-row sort network. Pick order is identical
    # to lax.top_k (value desc, index asc on ties; exhausted rows yield
    # distinct ascending -inf picks, which the was_cand gate discards).
    band_score = cand_score[..., lag_min:]  # maxima live in the band only
    iot = jnp.arange(band_score.shape[-1])
    excl = jnp.zeros(band_score.shape, dtype=bool)
    oh_slots = []
    for _ in range(k):
        avail = jnp.where(excl, -jnp.inf, band_score)
        mx = jnp.max(avail, axis=-1, keepdims=True)
        tie = (avail == mx) & ~excl
        idx = jnp.min(jnp.where(tie, iot, iot.shape[0]), axis=-1, keepdims=True)
        oh = iot == idx
        excl = excl | oh
        oh_slots.append(oh)

    # sinc refinement (Praat NUMimproveMaximum): computed densely for every
    # lag (no data-dependent gathers — see _refine_sinc_dense), then read
    # off at the selected candidate lags. Mirror r at lag 0 for the left
    # support (exact for the symmetric 'ac' autocorrelation; the cc
    # candidates sit ≥ lag_min inside).
    ext_left = depth + 2
    r_ext = jnp.concatenate(
        [jnp.flip(r_full[..., 1 : ext_left + 1], axis=-1), r_full], axis=-1
    )
    # Refinement is evaluated on the band [lag_min, lag_max] only — every
    # finite-score candidate lies inside (``in_range`` gates ``is_max``).
    pos_l, val_l = _refine_sinc_dense(
        r_ext, ext_left, lag_max, depth, lag_lo=lag_min
    )
    # candidate readoff via one-hot contraction, not take_along_axis: the
    # fused one-hot reduction over [NF, k, nl] avoids three [NF, k]-element
    # gathers.
    ohc = jnp.stack(oh_slots, axis=-2).astype(r.dtype)  # [NF, k, nl_band]
    top_lag = jnp.sum(ohc * pos_l[..., None, :], axis=-1)
    val_sinc = jnp.sum(ohc * val_l[..., None, :], axis=-1)
    # Praat's reflection-around-1 of the refined strength
    val_sinc = jnp.where(val_sinc > 1.0, 1.0 / jnp.maximum(val_sinc, 1e-12), val_sinc)
    tau_top = top_lag / sr
    # Viterbi strength follows Praat's path finder: octave cost referenced
    # to the CEILING — strength − octaveCost·log2(ceiling/f) — not to
    # minPitch (minPitch-referenced cost is used only for the candidate
    # top-k selection above, as in Sound_to_Pitch's elite registration).
    # The constant log2(ceiling/minPitch)·octaveCost offset only moves
    # voiced-vs-UNVOICED comparisons, which is exactly why it must match.
    top_s = val_sinc - octave_cost * jnp.log2(jnp.maximum(max_pitch * tau_top, 1e-12))
    # candidates whose selection slot was empty (score -inf) stay invalid
    was_cand = jnp.sum(ohc * is_max[..., None, lag_min:], axis=-1) > 0.5
    freqs = jnp.where(was_cand, sr / jnp.maximum(top_lag, 1e-6), 0.0)
    # clamp out-of-range candidates to unvoiced
    valid = was_cand & (freqs > min_pitch * 0.99) & (freqs < max_pitch * 1.01)
    strengths = jnp.where(valid, top_s, -1e30)

    # unvoiced candidate strength (Praat path finder): intensity is
    # localPeak/globalPeak capped at 1 (Sound_to_Pitch stores it capped)
    intensity = jnp.minimum(local_peak / global_peak, 1.0)
    ratio = intensity / (silence_thresh / (1.0 + voicing_thresh))
    s_unvoiced = voicing_thresh + jnp.maximum(0.0, 2.0 - ratio)

    all_strength = jnp.concatenate([strengths, s_unvoiced[:, None]], axis=-1)  # [NF, K]
    all_freq = jnp.concatenate([freqs, jnp.zeros_like(s_unvoiced[:, None])], axis=-1)
    all_valid = jnp.concatenate([valid, jnp.ones_like(s_unvoiced[:, None], dtype=bool)], -1)

    # ---- Viterbi path finder (Praat cost conventions) --------------------
    corr = 0.01 / dt
    jump_c = octave_jump_cost * corr
    vuv_c = voiced_unvoiced_cost * corr

    # The octave-jump cost |log2(f_prev/f_cur)| is evaluated over a [K, K]
    # grid per frame; those K²·NF transcendentals dominated the scan body.
    # log2(a/b) = log2(a) − log2(b) moves the log2s OUT of the scan as one
    # [NF, K] elementwise pass (K²/K = 15× fewer evals), leaving only
    # subtract/abs/selects per step. NOTE
    # this changes the float rounding of the jump cost (one division+log2
    # vs a difference of two log2s, rel ~1e-7): decode flips are possible
    # only on exact cost ties, none observed on the golden fixtures.
    lf = jnp.log2(jnp.maximum(all_freq, 1e-6))  # [NF, K]
    vflag = all_freq > 0

    def step(delta_prev, inp):
        both_v = inp["vp"][:, None] & inp["v"][None, :]
        one_uv = inp["vp"][:, None] ^ inp["v"][None, :]
        jump = jnp.abs(inp["lfp"][:, None] - inp["lf"][None, :])
        cost = jnp.where(both_v, jump_c * jump, jnp.where(one_uv, vuv_c, 0.0))
        scores = delta_prev[:, None] - cost  # [K, K]
        best_prev = jnp.argmax(scores, axis=0)
        delta_t = inp["s"] + jnp.max(scores, axis=0)
        return delta_t, best_prev

    k_tot = all_strength.shape[-1]
    delta0 = all_strength[0]
    inps = {
        "s": all_strength[1:],
        "lf": lf[1:], "v": vflag[1:],
        "lfp": lf[:-1], "vp": vflag[:-1],
    }
    # unroll: the [K, K]=15² relax body is tiny against the per-step scan
    # overhead — unrolling 8× amortizes it the same way the pyin Viterbi
    # scan does (ops/yin.py)
    delta_f, backptrs = jax.lax.scan(step, delta0, inps, unroll=8)

    # backtrace
    last = jnp.argmax(delta_f if nf > 1 else delta0)

    def back_step(nxt, bp):
        cur = bp[nxt]
        return cur, cur

    _, path_rev = jax.lax.scan(back_step, last, backptrs, reverse=True, unroll=8)
    path = jnp.concatenate([path_rev, jnp.asarray([last])]) if nf > 1 else jnp.asarray([last])
    # one-hot readoff (same rationale as the candidate readoff above)
    f0 = jnp.sum(
        jnp.where(path[:, None] == jnp.arange(k_tot), all_freq, 0.0), axis=-1
    )
    return f0


def pitch_ac(x: jnp.ndarray, **kw) -> jnp.ndarray:
    """Public entry — see ``_pitch_ac_jit`` for the full signature/docs.

    Validates the engine name here (not in the traced body): a typo'd
    engine must error, not silently run the default."""
    if kw.get("ac_engine", "auto") not in ("auto", "matmul", "fft"):
        raise ValueError(
            f"ac_engine {kw['ac_engine']!r} not in ('auto', 'matmul', 'fft')"
        )
    return _pitch_ac_jit(x, **kw)
