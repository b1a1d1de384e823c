"""Spectral transforms: STFT power, mel filterbank, log compression, DCT → MFCC.

This is the accelerator-side replacement for the reference's single call
into ``librosa.feature.mfcc`` (reference: script/mfcc.py:387). Everything is
expressed as static-shape matmuls + elementwise ops so XLA can fuse the whole
front-end and hand the contractions to the GEMM libraries:

    frames [N, n_fft] --(x2 matmul vs. windowed DFT bases)--> re, im [N, n_bins]
    power = re^2 + im^2
    mel   = power @ M^T          (mel filterbank, Slaney-normalized)
    db    = power_to_db(mel)     (librosa ref=1.0, amin=1e-10, top_db=80)
    mfcc  = db @ D^T             (DCT-II, ortho)

All matrices are designed host-side in float64 numpy and closed over as
constants; only the matmuls/elementwise run on device. An ``jnp.fft.rfft``
path is kept as the oracle/fallback (bit-closer to numpy on CPU).

The DFT-as-matmul front-end comes in precision tiers (:data:`SPECTRA`), each
a fixed arithmetic whose error budget the tests pin:

  * ``'matmul'``      — float32 operands at ``Precision.HIGHEST``;
  * ``'matmul_x3'``   — bf16 hi/lo operand split, three bf16 dots with f32
    accumulation (~2⁻¹⁷ relative operand error);
  * ``'matmul_bf16'`` — one bf16 dot with f32 accumulation (corpus grade);
  * ``'matmul_i24'``  — 24-bit fixed point: frames and weights split into
    balanced int8 digit planes, three int8 dots with exact int32
    accumulation (f32-grade);
  * ``'matmul_i16'``  — 16-bit fixed point: two int8 audio digits, exact for
    int16-PCM-origin audio (the corpus upload format).

The tiers consume only the analysis window's support (``win_length`` of the
``n_fft`` samples) and only the bins some mel filter weights.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp

from modulation_mfcc.ops.framing import frame_by_slices
from modulation_mfcc.ops.windows import get_window
from modulation_mfcc.utils.helpers import pad_center

SPECTRA = ("fft", "matmul", "matmul_x3", "matmul_bf16", "matmul_i24", "matmul_i16")
# names of the retired fused-kernel spectra → the XLA tier with the same
# arithmetic
_RENAMED = {
    "pallas": "matmul", "pallas_x3": "matmul_x3", "pallas_bf16": "matmul_bf16",
    "pallas_i24": "matmul_i24", "pallas_i16": "matmul_i16",
}


def check_spectrum(spectrum: str) -> str:
    """Validate a spectrum name; a retired name raises with its replacement."""
    if spectrum in _RENAMED:
        raise ValueError(
            f"spectrum {spectrum!r} is now {_RENAMED[spectrum]!r} "
            "(same arithmetic, XLA form)"
        )
    if spectrum not in SPECTRA:
        raise ValueError(f"Unknown spectrum {spectrum!r}; one of {', '.join(SPECTRA)}")
    return spectrum

# ---------------------------------------------------------------------------
# Host-side designs (float64 numpy, cached)
# ---------------------------------------------------------------------------


def fft_frequencies(sr: float, n_fft: int) -> np.ndarray:
    """Center frequencies of rFFT bins (librosa.fft_frequencies)."""
    return np.linspace(0.0, sr / 2.0, 1 + n_fft // 2, endpoint=True)


def hz_to_mel(f, htk: bool = False):
    """Hz→mel. Slaney (librosa default) unless htk=True."""
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    mels = np.where(log_t, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz(mels, htk: bool = False):
    """mel→Hz inverse of :func:`hz_to_mel`."""
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = mels >= min_log_mel
    freqs = np.where(log_t, min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)
    return freqs


@lru_cache(maxsize=64)
def mel_filterbank(
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    htk: bool = False,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape [n_mels, 1+n_fft//2].

    Matches ``librosa.filters.mel`` (the implicit filterbank inside the
    reference's MFCC call, script/mfcc.py:387 with fmin=100, fmax=10000).
    Note the reference passes fmax above Nyquist; like librosa, filters whose
    support exceeds Nyquist simply have empty rows.
    """
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = fft_frequencies(sr, n_fft)
    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2), htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    # Slaney normalization: scale each filter to ~constant energy per channel
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights = weights * enorm[:, None]
    return weights


@lru_cache(maxsize=16)
def dct_matrix(n_out: int, n_in: int) -> np.ndarray:
    """DCT-II with 'ortho' norm as a matrix [n_out, n_in].

    ``dct_matrix(k, n) @ x == scipy.fft.dct(x, type=2, norm='ortho')[:k]``,
    the liftering step of librosa.feature.mfcc.
    """
    n = np.arange(n_in)
    k = np.arange(n_out)[:, None]
    mat = 2.0 * np.cos(np.pi * k * (2 * n[None, :] + 1) / (2 * n_in))
    scale = np.full((n_out, 1), np.sqrt(1.0 / (2 * n_in)))
    scale[0, 0] = np.sqrt(1.0 / (4 * n_in))
    return mat * scale


@lru_cache(maxsize=64)
def dft_bases(n_fft: int, window: str = "hann", win_length: int | None = None):
    """Windowed real-DFT bases over the full frame (a reference for tests;
    the tiers use :func:`tier_bases`).

    Returns (wr, wi) each [n_fft, 1+n_fft//2] float32 such that for a raw
    (unwindowed) frame row-vector f: ``re = f @ wr``, ``im = f @ wi`` equal the
    rFFT of (f * padded_window).
    """
    if win_length is None:
        win_length = n_fft
    w = pad_center(get_window(window, win_length, periodic=True), n_fft)
    n = np.arange(n_fft)[:, None]
    k = np.arange(1 + n_fft // 2)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    wr = np.cos(ang) * w[:, None]
    wi = np.sin(ang) * w[:, None]
    return wr.astype(np.float32), wi.astype(np.float32)


@lru_cache(maxsize=64)
def analysis_window(n_fft: int, window: str = "hann", win_length: int | None = None) -> np.ndarray:
    """Zero-padded (centered) analysis window of length n_fft, float64."""
    if win_length is None:
        win_length = n_fft
    return pad_center(get_window(window, win_length, periodic=True), n_fft)


# ---------------------------------------------------------------------------
# Device-side ops (JAX)
# ---------------------------------------------------------------------------

# float32 matmuls at DEFAULT precision may run with reduced-precision operands
# (TF32 on the GPU, about three decimal digits) — a 2.6e-3-class error on the
# MFCC parity gate. The parity path pins HIGHEST; the reduced tiers below
# state their operand types explicitly instead.
_PARITY_PRECISION = jax.lax.Precision.HIGHEST


def _pdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(a, b, precision=_PARITY_PRECISION)


def power_spectrum_fft(frames: jnp.ndarray, n_fft: int, window_vec: np.ndarray) -> jnp.ndarray:
    """|rFFT(frames * window)|^2 via jnp.fft — oracle/fallback path."""
    w = jnp.asarray(window_vec, dtype=frames.dtype)
    spec = jnp.fft.rfft(frames * w, n=n_fft, axis=-1)
    return jnp.real(spec) ** 2 + jnp.imag(spec) ** 2


def power_to_db(
    s: jnp.ndarray,
    *,
    amin: float = 1e-10,
    top_db: float | None = 80.0,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """librosa.power_to_db with ref=1.0: 10*log10(max(s, amin)), clipped to
    ``max - top_db``.

    The max is taken over the whole (per-utterance) spectrogram as librosa
    does for a single call. For padded batches pass ``mask`` (broadcastable,
    1=valid) so padding does not contaminate the per-utterance max; axes other
    than the leading batch axis are always reduced.
    """
    log_spec = 10.0 * jnp.log10(jnp.maximum(s, amin))
    if top_db is None:
        return log_spec
    # Per-utterance max: reduce the (frames, mel) trailing axes, keep leading
    # batch axes — matches librosa's per-call global max for a single
    # utterance while keeping padded batches independent per item.
    axes = tuple(range(s.ndim - 2, s.ndim))
    if mask is not None:
        neg = jnp.finfo(log_spec.dtype).min
        masked = jnp.where(mask > 0, log_spec, neg)
        peak = jnp.max(masked, axis=axes, keepdims=True)
    else:
        peak = jnp.max(log_spec, axis=axes, keepdims=True)
    return jnp.maximum(log_spec, peak - top_db)


def melspectrogram(
    frames: jnp.ndarray,
    *,
    sr: float,
    n_fft: int,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    window: str = "hann",
    win_length: int | None = None,
) -> jnp.ndarray:
    """Mel power spectrogram of pre-cut frames [..., N, n_fft] → [..., N, n_mels]
    (rFFT power; the matmul forms are the tiers of :func:`tier_mel`)."""
    p = power_spectrum_fft(frames, n_fft, analysis_window(n_fft, window, win_length))
    m = jnp.asarray(mel_filterbank(sr, n_fft, n_mels, fmin, fmax), dtype=frames.dtype)
    return _pdot(p, m.T)


def mfcc_from_frames(
    frames: jnp.ndarray,
    *,
    sr: float,
    n_fft: int,
    n_mfcc: int = 13,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    window: str = "hann",
    win_length: int | None = None,
    top_db: float | None = 80.0,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """MFCCs [..., N, n_mfcc] from frames; frame-major layout (time on rows).

    Composition matches librosa.feature.mfcc (reference: script/mfcc.py:387):
    melspectrogram(power=2) → power_to_db(top_db=80) → DCT-II-ortho over the
    mel axis → first n_mfcc coefficients. Note the output here is [time, coef]
    (transposed vs librosa's [coef, time]): time is the long dimension.
    """
    mel = melspectrogram(
        frames,
        sr=sr,
        n_fft=n_fft,
        n_mels=n_mels,
        fmin=fmin,
        fmax=fmax,
        window=window,
        win_length=win_length,
    )
    return mfcc_from_mel(mel, n_mfcc, top_db=top_db, mask=mask)


def mfcc_from_mel(
    mel: jnp.ndarray, n_mfcc: int, *, top_db: float | None = 80.0,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """power_to_db (per-utterance top_db clip) → DCT-II-ortho → first n_mfcc."""
    db = power_to_db(mel, top_db=top_db, mask=mask)
    d = jnp.asarray(dct_matrix(n_mfcc, mel.shape[-1]), dtype=mel.dtype)
    return _pdot(db, d.T)


# ---------------------------------------------------------------------------
# Precision tiers of the DFT-as-matmul front-end (see module docstring)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=32)
def tier_bases(sr: float, n_fft: int, win_length: int, n_mels: int,
               fmin: float, fmax: float | None):
    """Host-side float64 designs of the tiers: ``(pw, wri, mel_t)``.

    ``wri`` [win_length, 2·nb] holds the windowed cos | sin DFT columns on
    the window's support rows (frame samples ``pw … pw+win_length``; the
    centered Hann window is zero elsewhere), ``mel_t`` [nb, n_mels] the
    transposed Slaney filterbank; ``nb`` stops at the last bin any mel
    filter weights (the Nyquist bin is dropped when fmax ≤ sr/2)."""
    w = analysis_window(n_fft, "hann", win_length)
    pw = (n_fft - win_length) // 2
    mel = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    live = np.flatnonzero(np.abs(mel).sum(axis=0) > 0)
    nb = int(live[-1]) + 1 if live.size else 1 + n_fft // 2
    n = np.arange(pw, pw + win_length)[:, None]
    ang = -2.0 * np.pi * n * np.arange(nb)[None, :] / n_fft
    ws = w[pw : pw + win_length, None]
    wri = np.concatenate([np.cos(ang) * ws, np.sin(ang) * ws], axis=1)
    return pw, wri, np.ascontiguousarray(mel[:, :nb].T)


def _bf16_dot(x: jnp.ndarray, w: np.ndarray) -> jnp.ndarray:
    """One pass: bf16 operands, float32 accumulation."""
    return jnp.matmul(
        x.astype(jnp.bfloat16), jnp.asarray(w, dtype=jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )


def _split_bf16(x: jnp.ndarray):
    """float32 → (hi, lo) bf16 with hi = x rounded to bf16 (nearest even) and
    lo = bf16(x − hi). The rounding works on the bit pattern: a
    f32→bf16→f32 convert pair is an identity XLA may fold when it allows
    excess precision (the GPU default), which would leave lo = 0 and the
    tier at one-pass bf16 accuracy."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    rne = bits + (np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1)))
    hi = jax.lax.bitcast_convert_type(rne & np.uint32(0xFFFF0000), jnp.float32)
    return hi.astype(jnp.bfloat16), (x - hi).astype(jnp.bfloat16)


def _x3_dot(x: jnp.ndarray, w: np.ndarray) -> jnp.ndarray:
    """Three passes over bf16 (hi, lo) splits of both operands —
    hi·Whi + hi·Wlo + lo·Whi with float32 accumulation; the dropped lo·Wlo
    term is ~2⁻¹⁷ of the product."""
    w_hi = np.asarray(w, np.float32).astype(jnp.bfloat16)
    w_lo = (np.asarray(w, np.float64) - w_hi.astype(np.float64)).astype(jnp.bfloat16)
    hi, lo = _split_bf16(x)

    def dot(a, b):
        return jnp.matmul(a, jnp.asarray(b), preferred_element_type=jnp.float32)

    return dot(hi, w_hi) + dot(hi, w_lo) + dot(lo, w_hi)


def _idot(x: jnp.ndarray, w: np.ndarray) -> jnp.ndarray:
    """int8 × int8 → exact int32 accumulation."""
    return jnp.matmul(x, jnp.asarray(w, dtype=jnp.int8),
                      preferred_element_type=jnp.int32)


@lru_cache(maxsize=32)
def _int8_weight_planes(wri_bytes: bytes, shape: tuple):
    """Balanced base-256 digit planes ``(w2, w1, w0, Sw)`` of a weight matrix:
    ``W ≈ (w2·2¹⁶ + w1·2⁸ + w0) / Sw`` to ±0.5/Sw (≈ 2⁻²⁴·max|W|), every
    plane in [−128, 127] with no carry chains (host-side, float64)."""
    w = np.frombuffer(wri_bytes, dtype=np.float64).reshape(shape)
    sw = (127.0 * 65536.0 - 33000.0) / (float(np.max(np.abs(w))) or 1.0)
    r = np.round(w * sw).astype(np.int64)
    w0 = ((r + 128) % 256) - 128
    r1 = (r - w0) // 256
    w1 = ((r1 + 128) % 256) - 128
    w2 = (r1 - w1) // 256
    assert np.abs(w2).max() <= 127, "int8 plane overflow"
    return w2.astype(np.int8), w1.astype(np.int8), w0.astype(np.int8), sw


def tier_scale(spectrum: str, audio: jnp.ndarray):
    """Per-utterance quantization scale [..., 1] of the fixed-point tiers
    (None for the others), from the samples the frames are cut from.

    i24: ``s = (127·2¹⁶ − 33000) / max|x|`` so every ``round(x·s)`` is a
    24-bit integer whose balanced digits stay in int8. i16: the largest
    power of two with ``max(x)·s ≤ 32767`` and ``−min(x)·s ≤ 32768`` (the
    asymmetric int16 range of the digit split), built with frexp/ldexp —
    f32 exp2/log2 are not exact at integer points on XLA backends, and a
    non-power-of-two scale would put every odd PCM value on a half integer.
    Full-scale int16 audio gets exactly s = 32768; quiet utterances are
    lifted so the quantization is relative to the utterance's own level."""
    a = audio.astype(jnp.float32)
    if spectrum == "matmul_i24":
        amax = jnp.max(jnp.abs(a), axis=-1, keepdims=True)
        return (127.0 * 65536.0 - 33000.0) / jnp.maximum(amax, 1e-20)
    if spectrum == "matmul_i16":
        pmax = jnp.max(a, axis=-1, keepdims=True)
        nmax = -jnp.min(a, axis=-1, keepdims=True)
        ratio = 32768.0 / jnp.maximum(jnp.maximum(pmax, nmax), 1e-30)
        s = jnp.ldexp(jnp.float32(1.0), jnp.frexp(ratio)[1] - 1)
        # f32 division slop (ratio rounding up across a power of two)
        over = (pmax * s > 32767.0) | (nmax * s > 32768.0)
        s = jnp.where(over, s * 0.5, s)
        return jnp.minimum(s, jnp.float32(2.0**60))  # silence: zero output
    return None


def _i24_reim(frames, s, wri):
    """24-bit fixed-point windowed DFT: X = round(x·s) split into balanced
    int8 digits (x2, x1, x0) against the weight planes, three int8 dots —
        d1 = x2@w2,  d2 = [x2|x1]@[w1;w2],  d3 = [x2|x1|x0]@[w0;w1;w2]
    — i.e. every digit product ≥ 2⁻¹⁶ of full scale, recombined in f32 with
    power-of-two shifts. The dropped tail is 2⁻²⁴-class, like f32's own
    rounding."""
    w2, w1, w0, sw = _int8_weight_planes(wri.tobytes(), wri.shape)
    x = jnp.round(frames * s[..., None])
    q1 = jnp.floor((x + 128.0) * (1.0 / 256.0))
    x0 = x - 256.0 * q1
    q2 = jnp.floor((q1 + 128.0) * (1.0 / 256.0))
    x1 = q1 - 256.0 * q2
    f2, f1, f0 = (v.astype(jnp.int8) for v in (q2, x1, x0))
    x21 = jnp.concatenate([f2, f1], axis=-1)
    d1 = _idot(f2, w2)
    d2 = _idot(x21, np.concatenate([w1, w2]))
    d3 = _idot(jnp.concatenate([x21, f0], axis=-1), np.concatenate([w0, w1, w2]))
    inv = 1.0 / (s[..., None] * sw)
    return (
        d1.astype(jnp.float32) * 4294967296.0
        + d2.astype(jnp.float32) * 16777216.0
        + d3.astype(jnp.float32) * 65536.0
    ) * inv


def _i16_reim(frames, s, wri):
    """16-bit fixed-point windowed DFT. X = clip(round(x·s)) splits as
    X = x1·2⁸ + (x0s + 128) with x1 = floor(X/256) ∈ [−128, 127] and
    x0s ∈ [−128, 127]; against W·Sw = w2·2¹⁶ + w1·2⁸ + w0 three int8 dots
        d1 = x1@w2,  d2 = [x1|x0s]@[w1;w2],  d3 = [x1|x0s]@[w0;w1]
    keep every digit product ≥ 2⁻²⁴ of the utterance's scale; the +128
    offset of the low digit is the constant column vector
    corr = 128·Σ_k W·Sw. The dropped x0s·w0 term is sign-random across k
    (w0 is), so it stays a random walk even when x0s is constant (quiet
    int16 audio): one f32-grade unit at the mel surface."""
    w2, w1, w0, sw = _int8_weight_planes(wri.tobytes(), wri.shape)
    x = jnp.clip(jnp.round(frames * s[..., None]), -32768.0, 32767.0)
    x1 = jnp.floor(x * (1.0 / 256.0))
    x0s = x - 256.0 * x1 - 128.0
    f1, f0 = x1.astype(jnp.int8), x0s.astype(jnp.int8)
    x10 = jnp.concatenate([f1, f0], axis=-1)
    d1 = _idot(f1, w2)
    d2 = _idot(x10, np.concatenate([w1, w2]))
    d3 = _idot(x10, np.concatenate([w0, w1]))
    r_int = w2.astype(np.float64) * 65536.0 + w1 * 256.0 + w0
    corr = jnp.asarray(128.0 * r_int.sum(axis=0), dtype=jnp.float32)
    inv = 1.0 / (s[..., None] * sw)
    return (
        d1.astype(jnp.float32) * 16777216.0
        + d2.astype(jnp.float32) * 65536.0
        + d3.astype(jnp.float32) * 256.0
        + corr
    ) * inv


def tier_mel(frames: jnp.ndarray, spectrum: str, wri: np.ndarray,
             mel_t: np.ndarray, scale=None) -> jnp.ndarray:
    """Mel power [..., N, n_mels] of support frames [..., N, win_length]
    under a matmul tier. The fixed-point tiers project mel as x3 (its
    operands are non-negative, so the split error stays relative)."""
    nb = mel_t.shape[0]
    if spectrum == "matmul":
        reim = _pdot(frames, jnp.asarray(wri, dtype=frames.dtype))
    elif spectrum == "matmul_bf16":
        reim = _bf16_dot(frames, wri)
    elif spectrum == "matmul_x3":
        reim = _x3_dot(frames, wri)
    elif spectrum == "matmul_i24":
        reim = _i24_reim(frames, scale, wri)
    elif spectrum == "matmul_i16":
        reim = _i16_reim(frames, scale, wri)
    else:
        raise ValueError(f"not a matmul tier: {spectrum!r}")
    p = reim[..., :nb] ** 2 + reim[..., nb:] ** 2
    if spectrum == "matmul":
        return _pdot(p, jnp.asarray(mel_t, dtype=p.dtype))
    if spectrum == "matmul_bf16":
        return _bf16_dot(p, mel_t)
    return _x3_dot(p, mel_t)


def mfcc_centered(
    yp: jnp.ndarray,
    n_frames: int,
    *,
    spectrum: str,
    sr: float,
    n_fft: int,
    hop: int,
    win_length: int | None = None,
    n_mfcc: int = 13,
    n_mels: int = 128,
    fmin: float = 0.0,
    fmax: float | None = None,
    mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """MFCC [..., n_frames, n_mfcc] of audio ``yp`` [..., T'] that already
    carries the centered-framing pad (``n_fft // 2`` zeros before sample 0):
    frame f covers ``yp[f·hop : f·hop + n_fft]``. ``spectrum`` is 'fft' or a
    matmul tier; ``mask`` ([..., n_frames, 1], 1 = valid) keeps padding out
    of the per-utterance top_db peak."""
    check_spectrum(spectrum)
    win_length = win_length or n_fft
    if spectrum == "fft":
        frames = frame_by_slices(yp, 0, n_frames, n_fft, hop)
        return mfcc_from_frames(
            frames, sr=sr, n_fft=n_fft, n_mfcc=n_mfcc, n_mels=n_mels, fmin=fmin,
            fmax=fmax, win_length=win_length, mask=mask,
        )
    pw, wri, mel_t = tier_bases(sr, n_fft, win_length, n_mels, fmin, fmax)
    if spectrum != "matmul":
        yp = yp.astype(jnp.float32)
    frames = frame_by_slices(yp, pw, n_frames, win_length, hop)
    mel = tier_mel(frames, spectrum, wri, mel_t, tier_scale(spectrum, yp))
    return mfcc_from_mel(mel, n_mfcc, mask=mask)
