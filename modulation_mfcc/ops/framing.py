"""Signal framing for STFT-style analysis (device-side, JAX).

Design note: frame grids here are always regular (start0 + k*hop), so the
frame matrix assembles from contiguous strided slices (``frame_by_slices``)
— plain copies — rather than the naive ``x[starts + iota]`` gather.
Frame counts/time anchors are computed host-side from static lengths.

Semantics match librosa's centered STFT framing used by the reference's MFCC
call (reference: script/mfcc.py:387): the signal is padded by ``n_fft // 2``
zeros on both sides (librosa stft ``center=True, pad_mode='constant'``) and
frames of ``n_fft`` samples are taken every ``hop`` samples.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp


def n_frames_centered(n_samples: int, n_fft: int, hop: int) -> int:
    """Number of STFT frames for a centered transform (librosa convention)."""
    return 1 + (n_samples + 2 * (n_fft // 2) - n_fft) // hop


def frame_by_slices(
    x: jnp.ndarray, start0: int, n_frames: int, frame_length: int, hop: int
) -> jnp.ndarray:
    """Overlapping frames ``F[..., k, i] = x[..., start0 + k*hop + i]`` built
    from contiguous strided slices instead of a gather.

    The gather ``x[starts + iota]`` makes XLA gather row by row through
    device memory; the same matrix assembles from ``ceil(W/hop)``
    *contiguous* slices — column block ``c`` of all frames is the slice
    ``x[start0 + c*hop :][: n_frames*hop]`` reshaped to ``[n_frames, hop]``
    — which lowers to plain copies. Element-for-element identical to the
    gather; requires
    ``start0 + (n_frames-1)*hop + frame_length <= x.shape[-1]``.
    """
    W, H, nf = int(frame_length), int(hop), int(n_frames)
    n = x.shape[-1]
    if start0 + (nf - 1) * H + W > n:
        raise ValueError("frame_by_slices: frames read past the signal end")
    C = -(-W // H)  # ceil: column blocks of width H
    # zero-pad so every column block can take a full [nf*H] slice (the
    # padded tail only lands in trimmed columns >= W, never in the output)
    need = start0 + (C - 1) * H + nf * H
    if need > n:
        cfg = [(0, 0)] * (x.ndim - 1) + [(0, need - n)]
        x = jnp.pad(x, cfg)
    blocks = [
        jax.lax.slice_in_dim(x, start0 + c * H, start0 + c * H + nf * H, axis=-1).reshape(
            x.shape[:-1] + (nf, H)
        )
        for c in range(C)
    ]
    frames = blocks[0] if C == 1 else jnp.concatenate(blocks, axis=-1)
    return frames[..., :W]


def hop_window_sums(
    series: jnp.ndarray, nf: int, window: int, hop: int
) -> jnp.ndarray:
    """``out[..., f] = Σ series[..., f·hop : f·hop + window]``, f ∈ [0, nf).

    Frame starts are hop-aligned, so each window sum decomposes into
    ``window//hop`` whole hop-row sums plus one ``window%hop`` partial row:
    O(len) reads, no frame matrix, and no long-range cumsum — every output
    is a fresh ~window/hop-term sum of row sums, so there is no
    cancellation growth with position (unlike prefix-sum differences).
    Used by the RMS envelope (models/envelope.py) and the frameless pyin
    difference function (ops/yin.py). A series shorter than the row grid is
    zero-extended; callers guarantee valid windows only read real data.
    """
    q, rem = divmod(int(window), int(hop))
    n_rows = nf + q if rem else nf - 1 + q
    need = n_rows * hop
    length = series.shape[-1]
    if length < need:
        cfg = [(0, 0)] * (series.ndim - 1) + [(0, need - length)]
        series = jnp.pad(series, cfg)
    elif length > need:
        series = jax.lax.slice_in_dim(series, 0, need, axis=-1)
    rows = series.reshape(*series.shape[:-1], n_rows, hop)
    rs = jnp.sum(rows, axis=-1)
    out = sum(jax.lax.slice_in_dim(rs, r, r + nf, axis=-1) for r in range(q))
    if rem:
        pr = jnp.sum(rows[..., :rem], axis=-1)
        partial = jax.lax.slice_in_dim(pr, q, q + nf, axis=-1)
        out = out + partial if q else partial
    return out


def frame_signal(
    x: jnp.ndarray,
    frame_length: int,
    hop: int,
    *,
    center: bool = True,
    pad_mode: str = "constant",
) -> jnp.ndarray:
    """Slice ``x[..., T]`` into overlapping frames ``[..., n_frames, frame_length]``.

    With ``center=True`` pads ``frame_length // 2`` on each side first
    (librosa convention; ``pad_mode='constant'`` = zeros, the librosa>=0.10
    default used by the reference's ``librosa.feature.mfcc`` call).
    """
    n = x.shape[-1]
    if center:
        pad = frame_length // 2
        cfg = [(0, 0)] * (x.ndim - 1) + [(pad, pad)]
        if pad_mode == "constant":
            x = jnp.pad(x, cfg)
        elif pad_mode == "reflect":
            x = jnp.pad(x, cfg, mode="reflect")
        else:
            raise ValueError(f"Unsupported pad_mode {pad_mode!r}")
        total = n + 2 * pad
    else:
        total = n
    nf = 1 + (total - frame_length) // hop
    if nf <= 0:
        raise ValueError(
            f"Signal of length {n} too short for frame_length={frame_length}"
        )
    return frame_by_slices(x, 0, nf, frame_length, hop)


def hop_rows_geometry(n_samples: int, *, n_fft: int = 512, hop: int = 80) -> tuple[int, int]:
    """(rows_total, offset) of the hop-rows input contract for ``n_samples``:
    the audio sits at sample ``offset = n_fft // 2`` (the centered-framing
    pad) of a zero buffer of ``rows_total · hop`` samples, the smallest
    whole number of hop rows that holds the pad on both sides."""
    offset = n_fft // 2
    return -(-(int(n_samples) + 2 * offset) // hop), offset


def pack_hop_rows(audio, *, n_fft: int = 512, hop: int = 80):
    """[B, T] (or [T]) samples → [B, rows_total, hop] padded hop rows, the
    at-rest corpus format: the centered-framing pad is already in place, so
    the device only reshapes it back to flat audio. dtype-preserving (int16
    rows stay int16 and dequantize on device). numpy in → numpy out (the
    corpus assembler's one pad memcpy per file); jax in → device pad+reshape."""
    single = audio.ndim == 1
    if single:
        audio = audio[None, :]
    b, t = audio.shape
    rows_total, offset = hop_rows_geometry(t, n_fft=n_fft, hop=hop)
    if isinstance(audio, np.ndarray):
        out = np.zeros((b, rows_total * hop), dtype=audio.dtype)
        out[:, offset : offset + t] = audio
        return out.reshape(b, rows_total, hop)
    out = jnp.pad(audio, ((0, 0), (offset, rows_total * hop - t - offset)))
    return out.reshape(b, rows_total, hop)


def unpack_hop_rows(rows: jnp.ndarray, n_samples: int, *, n_fft: int, hop: int) -> jnp.ndarray:
    """Hop rows [B, rows_total, hop] → centered-padded float audio
    [B, rows_total·hop] (int16 rows dequantize by 2⁻¹⁵, which is exact)."""
    rows_total, _ = hop_rows_geometry(n_samples, n_fft=n_fft, hop=hop)
    if rows.shape[-1] != hop or rows.shape[-2] != rows_total:
        raise ValueError(
            f"hop rows of shape {rows.shape[-2:]} do not match the geometry "
            f"({rows_total}, {hop}) for n_samples={n_samples}; build them "
            "with pack_hop_rows"
        )
    flat = rows.reshape(*rows.shape[:-2], rows_total * hop)
    if jnp.issubdtype(flat.dtype, jnp.integer):
        return flat.astype(jnp.float32) * np.float32(2.0**-15)
    return flat


def frame_times_mfcc(n_frames: int, t_step: float, win_len: float) -> np.ndarray:
    """Time anchors of the reference's MFCC-change output.

    Reference: script/mfcc.py:390 —
    ``T = round((arange(1, n_frames+1) * tStep) + winLen/2, 4)``.
    Host-side (static shapes, float64, 4-decimal rounding preserved).
    """
    return np.round(np.arange(1, n_frames + 1) * t_step + win_len / 2.0, 4)


def frame_times_centered(n_frames: int, hop: int, sr: float) -> np.ndarray:
    """librosa ``frames_to_time``-style anchors: frame i at ``i * hop / sr``."""
    return np.arange(n_frames) * (hop / sr)
