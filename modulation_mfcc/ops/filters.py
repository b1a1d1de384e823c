"""Zero-phase IIR/FIR filtering on device.

Design/apply split (the device-side shape of the reference's filter stack,
script/mfcc.py:29-135 `applyFilter` and the inline Butterworth low-pass of
script/mfcc.py:398-402):

  * **Design is host-side** — filter parameters are static config, so
    Butterworth/FIR coefficients and steady-state initial conditions are
    computed once with scipy in float64 at trace time and closed over as
    constants in the compiled XLA program.
  * **Application is device-side** — the recurrence runs as a `lax.scan`
    over time, vectorized (vmap-style broadcasting) over every leading batch/
    coefficient axis; there is one scan per biquad
    section (cascades are short: order-6 Butterworth = 3 sections).

Zero-phase semantics replicate `scipy.signal.sosfiltfilt` / `filtfilt`
*exactly* (same odd extension, same default `padlen`, same `zi` scaling by the
first/last extended sample), because filtfilt edge behavior is the dominant
error term for the reference's 12 Hz low-pass on short trajectories
(SURVEY.md §7 "hard parts" #1).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import scipy.signal as _sps

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------------------
# Host-side design
# ---------------------------------------------------------------------------


@lru_cache(maxsize=128)
def design_butter_sos(order: int, wn: tuple, btype: str) -> tuple:
    """Butterworth SOS + steady-state zi, designed by scipy in float64.

    Returns (sos [ns,6], zi [ns,2], padlen) as numpy arrays / int. ``wn`` is
    the normalized cutoff tuple (1 value low/high, 2 values bandpass) exactly
    as the reference computes it (cutOff / (sr/2), script/mfcc.py:101,398).
    """
    wn_arr = np.asarray(wn, dtype=np.float64)
    sos = _sps.butter(order, wn_arr if wn_arr.size > 1 else wn_arr[0], btype=btype, output="sos")
    zi = _sps.sosfilt_zi(sos)
    ntaps = 2 * sos.shape[0] + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    padlen = 3 * int(ntaps)
    return sos, zi, padlen


@lru_cache(maxsize=128)
def design_firwin(numtaps: int, wn: tuple, pass_zero, beta: float = 7.4) -> tuple:
    """Kaiser-window FIR design matching the reference's firwin call
    (script/mfcc.py:120: ``firwin(filtLen, w, window=('kaiser', 7.4),
    pass_zero=filtType)``). Returns (b, zi, padlen) for use with filtfilt.
    """
    wn_arr = np.asarray(wn, dtype=np.float64)
    b = _sps.firwin(numtaps, wn_arr if wn_arr.size > 1 else wn_arr[0], window=("kaiser", beta), pass_zero=pass_zero)
    a = np.array([1.0])
    zi = _sps.lfilter_zi(b, a)
    padlen = 3 * max(len(a), len(b))
    return b, zi, padlen


# ---------------------------------------------------------------------------
# Device-side application
# ---------------------------------------------------------------------------


def odd_ext(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """Odd extension around the endpoints, scipy.signal._arraytools.odd_ext."""
    if n < 1:
        return x
    if n > x.shape[-1] - 1:
        raise ValueError(
            f"Extension length {n} must be < signal length {x.shape[-1]}"
        )
    left = 2.0 * x[..., :1] - x[..., n:0:-1]
    right = 2.0 * x[..., -1:] - x[..., -2 : -(n + 2) : -1]
    return jnp.concatenate([left, x, right], axis=-1)


def _biquad_scan(x_t: jnp.ndarray, b: np.ndarray, a: np.ndarray, zi_t: jnp.ndarray):
    """One direct-form-II-transposed biquad over time.

    x_t: [T, ...] time-major; zi_t: [2, ...]. Returns (y_t [T, ...], zf [2, ...]).
    Recurrence identical to scipy's sosfilt inner loop.
    """
    b0, b1, b2 = (float(v) for v in b)
    a1, a2 = float(a[1]), float(a[2])

    def step(carry, xn):
        z0, z1 = carry
        yn = b0 * xn + z0
        z0n = b1 * xn - a1 * yn + z1
        z1n = b2 * xn - a2 * yn
        return (z0n, z1n), yn

    (z0f, z1f), y = jax.lax.scan(step, (zi_t[0], zi_t[1]), x_t)
    return y, jnp.stack([z0f, z1f])


def sosfilt(sos: np.ndarray, x: jnp.ndarray, zi: jnp.ndarray | None = None) -> jnp.ndarray:
    """Cascaded biquad filtering along the last axis (scipy.signal.sosfilt).

    ``zi`` has shape [ns, ..., 2] broadcastable against x's leading dims
    (scipy convention); None means zero initial state.
    """
    x_t = jnp.moveaxis(x, -1, 0)
    for s in range(sos.shape[0]):
        if zi is None:
            z = jnp.zeros((2,) + x_t.shape[1:], dtype=x.dtype)
        else:
            zs = jnp.moveaxis(zi[s], -1, 0)  # [2, ...]
            z = jnp.broadcast_to(zs, (2,) + x_t.shape[1:]).astype(x.dtype)
        x_t, _ = _biquad_scan(x_t, sos[s, :3], sos[s, 3:], z)
    return jnp.moveaxis(x_t, 0, -1)


def sosfiltfilt(
    sos: np.ndarray, zi: np.ndarray, padlen: int, x: jnp.ndarray,
    *, bf16: bool = False,
) -> jnp.ndarray:
    """Zero-phase SOS filtering along the last axis == scipy.signal.sosfiltfilt.

    Dispatches between two exact implementations:
      * long signals → the FIR operator form (:func:`sosfiltfilt_fir`):
        a symmetric convolution (one GEMM, parallel over time) plus dense
        edge operators probed from scipy itself — no sequential scan at all;
      * short signals → the literal scan replication of scipy's
        odd-extension + zi construction.

    ``bf16=True`` runs the operator's products as bf16 multiplies with f32
    accumulation (the corpus-grade tier); otherwise float32 HIGHEST.
    """
    design = design_filtfilt_operator(_key_of(sos), padlen)
    if design is not None and x.shape[-1] >= design.min_len:
        return sosfiltfilt_fir(design, x, bf16=bf16)
    return sosfiltfilt_scan(sos, zi, padlen, x)


def sosfiltfilt_scan(sos: np.ndarray, zi: np.ndarray, padlen: int, x: jnp.ndarray) -> jnp.ndarray:
    """Scan-based sosfiltfilt (scipy's exact construction, sequential in T).

    Steps (scipy order): odd-extend by padlen → forward pass with zi scaled
    by first sample → reverse pass with zi scaled by (new) first sample →
    trim.
    """
    ext = odd_ext(x, padlen)
    # scipy shape convention: zi [ns, 2] broadcast over x's leading dims and
    # scaled by the first extended sample
    zi_b = np.asarray(zi).reshape((zi.shape[0],) + (1,) * (x.ndim - 1) + (2,))
    x0 = ext[..., :1]
    y = sosfilt(sos, ext, zi=jnp.asarray(zi_b) * x0[None, ..., :])
    y = jnp.flip(y, axis=-1)
    y0 = y[..., :1]
    y = sosfilt(sos, y, zi=jnp.asarray(zi_b) * y0[None, ..., :])
    y = jnp.flip(y, axis=-1)
    return y[..., padlen:-padlen] if padlen > 0 else y


def _lfilter_scan(b: np.ndarray, a: np.ndarray, x: jnp.ndarray, zi: jnp.ndarray):
    """Direct-form-II-transposed lfilter along last axis with state zi [..., K]."""
    k = max(len(a), len(b)) - 1
    bb = np.zeros(k + 1)
    bb[: len(b)] = b
    aa = np.zeros(k + 1)
    aa[: len(a)] = a
    bb = bb / aa[0]
    aa = aa / aa[0]
    b_rest = jnp.asarray(bb[1:], dtype=x.dtype)
    a_rest = jnp.asarray(aa[1:], dtype=x.dtype)
    x_t = jnp.moveaxis(x, -1, 0)

    def step(z, xn):
        yn = bb[0] * xn + z[..., 0]
        shifted = jnp.concatenate(
            [z[..., 1:], jnp.zeros_like(z[..., :1])], axis=-1
        )
        zn = shifted + xn[..., None] * b_rest - yn[..., None] * a_rest
        return zn, yn

    zf, y = jax.lax.scan(step, zi, x_t)
    return jnp.moveaxis(y, 0, -1), zf


def filtfilt(b: np.ndarray, a: np.ndarray, zi: np.ndarray, padlen: int, x: jnp.ndarray) -> jnp.ndarray:
    """Zero-phase transversal filtering == scipy.signal.filtfilt (padtype odd).

    Used for the reference's FIR branch (script/mfcc.py:126: filtfilt(bFil,1,x)).
    """
    ext = odd_ext(x, padlen)
    zi_b = jnp.asarray(zi, dtype=x.dtype)
    zi_full = jnp.broadcast_to(zi_b, ext.shape[:-1] + zi_b.shape)
    y, _ = _lfilter_scan(b, a, ext, zi_full * ext[..., :1])
    y = jnp.flip(y, axis=-1)
    y2, _ = _lfilter_scan(b, a, y, zi_full * y[..., :1])
    y2 = jnp.flip(y2, axis=-1)
    return y2[..., padlen:-padlen] if padlen > 0 else y2


# ---------------------------------------------------------------------------
# FIR operator form of sosfiltfilt (exact, scan-free)
# ---------------------------------------------------------------------------
#
# scipy's sosfiltfilt is a *linear* operator H on the input vector. Away from
# the signal ends H is Toeplitz: row n is a shifted copy of the zero-phase
# impulse response h (symmetric, decaying like the slowest pole). Within
# E = K + padlen samples of either end the rows differ (odd extension + zi
# scaling), but they only depend on the first/last W samples. So the whole
# operator is: one SAME-convolution with the truncated kernel (length 2K+1,
# a matmul, fully parallel over time) plus two small dense edge matmuls.
#
# The kernel and edge blocks are *probed from scipy itself* at design time
# (push an identity matrix through scipy.sosfiltfilt): exactness to scipy is
# by construction; the only approximation is the kernel truncation at the
# pole-decay tolerance (1e-10). This removes the sequential scan entirely
# (hour-scale recordings are ~10^6 frames of 2x3 biquad scan otherwise).


class FirFiltfiltDesign:
    """Probed operator: kernel [2K+1], left/right edge blocks [E, W]."""

    __slots__ = ("kernel", "left", "right", "K", "E", "W", "min_len")

    def __init__(self, kernel, left, right, K, E, W, min_len):
        self.kernel = kernel
        self.left = left
        self.right = right
        self.K = K
        self.E = E
        self.W = W
        self.min_len = min_len


@lru_cache(maxsize=64)
def _operator_cache(sos_bytes: bytes, n_sections: int, padlen: int):
    sos = np.frombuffer(sos_bytes, dtype=np.float64).reshape(n_sections, 6).copy()
    # slowest pole sets the kernel truncation length
    pmax = 0.0
    for s in range(n_sections):
        rts = np.roots(sos[s, 3:])
        if len(rts):
            pmax = max(pmax, float(np.max(np.abs(rts))))
    if pmax >= 0.99999:
        return None  # effectively infinite memory: keep the scan path
    K = int(np.ceil(np.log(1e-10) / np.log(max(pmax, 1e-6))))
    K = max(K, padlen + 1)
    if K > 8192:
        return None
    E = K + padlen
    W = E + 2 * K
    n_probe = 2 * W + 2 * K
    H = _sps.sosfiltfilt(sos, np.eye(n_probe), axis=0)
    mid = n_probe // 2
    kernel = H[mid, mid - K : mid + K + 1].copy()
    left = H[:E, :W].copy()
    right = H[-E:, -W:].copy()
    # support check: edge rows must not reach beyond W
    if np.max(np.abs(H[:E, W:])) > 1e-9 or np.max(np.abs(H[-E:, :-W])) > 1e-9:
        return None
    # self-check: operator reproduces scipy on a random vector
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n_probe)
    want = _sps.sosfiltfilt(sos, x)
    interior = np.convolve(x, kernel[::-1], mode="valid")  # y[K .. n-K)
    got = np.concatenate([left @ x[:W], interior[E - K : n_probe - E - K], right @ x[-W:]])
    if np.max(np.abs(got - want)) > 1e-7:
        return None
    min_len = max(2 * E + 1, W)
    return FirFiltfiltDesign(kernel, left, right, K, E, W, min_len)


def _key_of(sos: np.ndarray):
    sos64 = np.ascontiguousarray(sos, dtype=np.float64)
    return sos64.tobytes(), sos64.shape[0]


def design_filtfilt_operator(key, padlen: int):
    return _operator_cache(key[0], key[1], padlen)


def _linear(a: jnp.ndarray, w, bf16: bool) -> jnp.ndarray:
    """``a @ w``: float32 HIGHEST, or bf16 operands with f32 accumulation."""
    if bf16:
        return jnp.matmul(
            a.astype(jnp.bfloat16), jnp.asarray(w, dtype=jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    return jnp.matmul(a, jnp.asarray(w, dtype=a.dtype),
                      precision=jax.lax.Precision.HIGHEST)


def _conv_valid_lastaxis(
    x: jnp.ndarray, kernel: np.ndarray, *, bf16: bool = False
) -> jnp.ndarray:
    """VALID cross-correlation along the last axis.

    Long kernels route through a blocked Toeplitz matmul — 128 outputs per
    block against a [128+K-1, 128] banded kernel matrix — because XLA lowers
    a single-channel conv1d to shift-accumulate, while this form is one GEMM
    (the 483-tap filtfilt kernels). ``bf16`` as in :func:`_linear`."""
    kernel = np.asarray(kernel, dtype=np.float64)
    klen = kernel.shape[0]
    t = x.shape[-1]
    lead = x.shape[:-1]
    n_out = t - klen + 1
    if klen >= 96 and n_out >= 128:
        blk = 128
        w = blk + klen - 1
        nb = -(-n_out // blk)
        # overlapping windows (stride blk, width w) assembled GATHER-FREE:
        # reshape to blk-sample rows and concat n_shift shifted row slices
        # (ops/framing.frame_by_slices' trick). The extra wpad−w columns
        # multiply zero kernel rows: bit-identical output.
        n_shift = -(-w // blk)
        wpad = n_shift * blk
        rows_total = nb + n_shift
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, rows_total * blk - t)])
        rows = xp.reshape(lead + (rows_total, blk))
        x3 = jnp.concatenate(
            [rows[..., k : k + nb, :] for k in range(n_shift)], axis=-1
        )  # [..., nb, wpad]; x3[..., b, l] == xp[..., b*blk + l]
        km = np.zeros((wpad, blk), dtype=np.float64)
        for j in range(blk):
            km[j : j + klen, j] = kernel
        out = _linear(x3, km, bf16)  # [..., nb, blk]
        return out.reshape(lead + (nb * blk,))[..., :n_out]
    dt = jnp.bfloat16 if bf16 else x.dtype
    xr = x.reshape((-1, 1, t)).astype(dt)
    k = jnp.asarray(kernel, dtype=dt)[None, None, :]
    out = jax.lax.conv_general_dilated(
        xr, k, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        precision=None if bf16 else jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32 if bf16 else None,
    )
    return out[:, 0, :].reshape(lead + (t - klen + 1,))


def sosfiltfilt_fir(
    d: FirFiltfiltDesign, x: jnp.ndarray, *, bf16: bool = False
) -> jnp.ndarray:
    """Apply the probed filtfilt operator (exact == scipy for len >= min_len
    in float32 HIGHEST; ``bf16`` = bf16 multiplies for the corpus mode)."""
    n = x.shape[-1]
    # kernel is symmetric; correlation == convolution
    interior = _conv_valid_lastaxis(x, d.kernel, bf16=bf16)  # y[K .. n-K)
    mid = interior[..., d.E - d.K : n - d.E - d.K]
    left = _linear(x[..., : d.W], d.left.T, bf16)
    right = _linear(x[..., -d.W :], d.right.T, bf16)
    return jnp.concatenate([left, mid, right], axis=-1)


# ---------------------------------------------------------------------------
# applyFilter equivalent (reference script/mfcc.py:29-135 / calc.py:23-129)
# ---------------------------------------------------------------------------

_FILT_TYPES = ("bandpass", "lowpass", "highpass")


def resolve_filt_type(filt_type: str) -> str:
    """Partial-match filter type resolution, same rule as the reference
    (script/mfcc.py:88-92): prefix match against bandpass/lowpass/highpass."""
    matches = [t for t in _FILT_TYPES if t.startswith(filt_type)]
    if len(matches) != 1:
        raise ValueError(
            "filtType must be one among: lowpass, highpass, bandpass. "
            "Partial matches allowed."
        )
    return matches[0]


def apply_filter(
    x: jnp.ndarray,
    sr: float,
    *,
    filt: str = "iir",
    cut_off=(None,),
    filt_len: int = 6,
    filt_type: str = "low",
    poly_ord: int = 3,
) -> jnp.ndarray:
    """JAX equivalent of the reference's applyFilter (script/mfcc.py:29-135).

    Validation rules mirror the reference: cutoffs must be < sr/2 and
    monotonically increasing; 'sg' takes exactly one cutoff (unused).
    """
    if filt is None:
        raise ValueError(
            "Cannot apply filter without specifying a filter method among "
            "'iir', 'fir' and 'sg' (filt is None)."
        )
    if cut_off is None or (filt != "sg" and any(c is None for c in cut_off)):
        raise ValueError(
            "Cannot apply filter without specifying a cut Off freq. (CutOff is None)."
        )
    ftype = resolve_filt_type(filt_type)
    cut = np.asarray([c for c in cut_off if c is not None], dtype=np.float64)
    if filt != "sg":
        if np.any(cut >= sr / 2.0):
            raise ValueError(
                "Cut off frequencies must be smaller than the half of the "
                "sampling freq. of the signal submitted to the filter"
            )
        if cut.size > 1 and np.any(np.diff(cut) <= 0):
            raise ValueError("If two cut off freqs are provided: cutOff[0]<cutOff[1]")
        ok = (cut.size == 1 and ftype in ("lowpass", "highpass")) or (
            cut.size == 2 and ftype == "bandpass"
        )
        if not ok:
            raise ValueError(
                "only one or two cut off frequencies allowed. If two freqs are "
                "provided, filtType must be bandpass"
            )
        wn = tuple((cut / (sr / 2.0)).tolist())
    if filt == "iir":
        sos, zi, padlen = design_butter_sos(filt_len, wn, ftype)
        return sosfiltfilt(sos, zi, padlen, x)
    if filt == "fir":
        b, zi, padlen = design_firwin(filt_len, wn, ftype)
        return filtfilt(b, np.array([1.0]), zi, padlen, x)
    if filt == "sg":
        if len(cut_off) != 1:
            raise ValueError(
                "sg (savitsky Golay) filters can only be lowpass (one cutOff freq allowed)"
            )
        from modulation_mfcc.ops.savgol import savgol_filter_jax

        return savgol_filter_jax(x, filt_len, poly_ord, deriv=0)
    raise ValueError(f"Unknown filter kind {filt!r}")
