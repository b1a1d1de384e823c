"""MFCC rate-of-change ("modulation cepstrum") — the flagship pipeline.

JAX rebuild of the reference's hot loop ``get_MFCCS_change``
(script/mfcc.py:291-427, Goldstein-2019 formulation):

    audio → centered frames → (window·DFT → power → mel → dB → DCT) → drop C0
          → per-coefficient zero-phase Butterworth low-pass (12 Hz default)
          → time derivative (np.gradient or SG) → sqrt(Σ_coef d²)/n_coef
          → final low-pass (Goldstein) or custom out-filter

Everything between the frames gather and the output is static-shape XLA:
the spectral stage is FFTs or matmuls, the filters are FIR-operator
convolutions (or scans for short inputs) vectorized over the coefficient
axis, the reduction is a single fused elementwise+reduce.
Batched inputs ([B, T] with optional per-utterance masks) run the exact same
program under vmap-style broadcasting; the per-utterance top_db clip is
mask-aware so padded batches match per-file outputs.

Also provides ``modulation_spectrum``: a second-stage STFT over the MFCC
coefficient trajectories (the BASELINE.json config-3 extension).
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.ops import filters as F
from modulation_mfcc.ops import masked
from modulation_mfcc.ops.derivatives import np_gradient
from modulation_mfcc.ops.framing import (
    frame_signal,
    frame_times_mfcc,
    n_frames_centered,
    unpack_hop_rows,
)
from modulation_mfcc.ops.savgol import savgol_filter_jax
from modulation_mfcc.ops.spectral import mfcc_centered

__all__ = ["mfcc_trajectories", "mfcc_change", "extract_mfcc_change", "modulation_spectrum"]


def mfcc_trajectories(
    y: jnp.ndarray,
    cfg: MfccConfig,
    *,
    frame_mask: jnp.ndarray | None = None,
    use_fft: bool = True,
    spectrum: str | None = None,
    coef_major: bool = False,
    n_samples: int | None = None,
) -> jnp.ndarray:
    """MFCC matrix [..., n_frames, n_mfcc] with librosa semantics
    (reference: script/mfcc.py:387). ``coef_major=True`` returns
    [..., n_mfcc, n_frames] instead. Same numbers either way.

    3-D ``y`` = pre-laid-out hop rows [B, rows, hop] (``n_samples``
    required) — the corpus at-rest contract, see ops/framing.pack_hop_rows.

    ``spectrum`` selects the front-end (ops/spectral.SPECTRA):
      * 'fft'         — framing + jnp.fft.rfft (oracle path, the default)
      * 'matmul'      — windowed-DFT matmuls at float32 HIGHEST precision
                        (parity ≈1e-5 at the MFCC level)
      * 'matmul_i24'  — 24-bit fixed-point int8-plane DFT: f32-grade MFCC
                        parity for any float audio
      * 'matmul_i16'  — 16-bit fixed-point DFT (two int8 audio digits):
                        exact for int16-PCM-origin audio (the corpus upload
                        format), f32-grade MFCC parity
      * 'matmul_x3'   — three-pass bf16-split matmuls: ~1e-3-grade MFCC
                        error (≤1e-4 at the mfcc_change output)
      * 'matmul_bf16' — one bf16 pass (corpus throughput mode; ~0.5
                        absolute MFCC-dB error)
    The legacy ``use_fft=False`` maps to 'matmul'.
    """
    if spectrum is None:
        spectrum = "fft" if use_fft else "matmul"
    hop, n_fft = cfg.hop_length, cfg.n_fft
    if y.ndim == 3:
        if n_samples is None:
            raise ValueError("hop-rows input [B, rows, hop] requires n_samples")
        n = int(n_samples)
        yp = unpack_hop_rows(y, n, n_fft=n_fft, hop=hop)
    else:
        n = y.shape[-1]
        pad = n_fft // 2
        yp = jnp.pad(y, [(0, 0)] * (y.ndim - 1) + [(pad, pad)])
    m = mfcc_centered(
        yp,
        n_frames_centered(n, n_fft, hop),
        spectrum=spectrum,
        sr=cfg.signal_sample_rate,
        n_fft=n_fft,
        hop=hop,
        win_length=cfg.win_length,
        n_mfcc=cfg.n_mfcc,
        n_mels=cfg.n_mels,
        fmin=cfg.minFreq,
        fmax=cfg.maxFreq,
        mask=None if frame_mask is None else frame_mask[..., :, None],
    )
    return jnp.swapaxes(m, -1, -2) if coef_major else m


def mfcc_change(
    y: jnp.ndarray,
    cfg: MfccConfig,
    *,
    frame_mask: jnp.ndarray | None = None,
    frame_lengths: jnp.ndarray | None = None,
    use_fft: bool = True,
    spectrum: str | None = None,
    masked_fir: bool = False,
    n_samples: int | None = None,
) -> jnp.ndarray:
    """Total MFCC change over time, [..., n_frames].

    3-D ``y`` = pre-laid-out hop rows (``n_samples`` required): the corpus
    at-rest contract — see ops/framing.pack_hop_rows.

    ``masked_fir=True`` (static) switches the masked filter stages to the
    FIR-operator form (ops/masked.masked_sosfiltfilt_fir) — much faster to
    compile and run, valid only when every utterance has at least the
    operator's ``min_len`` frames (callers with host-side length knowledge,
    e.g. bucketed batching, assert this).

    Line-by-line parity with get_MFCCS_change (script/mfcc.py:387-427); time
    anchors are host-side via :func:`change_times`.

    For padded batches pass ``frame_lengths`` [B] (valid frame count per
    utterance): the filter/derivative stages then use the length-masked edge
    variants (ops/masked.py) so every utterance's output matches its
    single-file result exactly on valid frames.
    """
    if frame_lengths is not None and frame_mask is None:
        t_for_mask = int(n_samples) if y.ndim == 3 else y.shape[-1]
        nf_pad = n_frames_centered(t_for_mask, cfg.n_fft, cfg.hop_length)
        mask_dtype = jnp.float32 if y.ndim == 3 else y.dtype
        frame_mask = (
            jnp.arange(nf_pad)[None, :] < frame_lengths[:, None]
        ).astype(mask_dtype)
    # coef-major trajectories so the filter stages run along the last
    # (time) axis
    m = mfcc_trajectories(
        y, cfg, frame_mask=frame_mask, use_fft=use_fft, spectrum=spectrum,
        coef_major=True, n_samples=n_samples,
    )
    if cfg.removeFirst:
        m = m[..., 1:, :]
    n_coef = m.shape[-2]
    traj = m  # [..., n_coef, n_frames]
    fs_traj = 1.0 / cfg.tStep
    cut_norm = cfg.filtCutoff / (fs_traj / 2.0)
    sos, zi, padlen = F.design_butter_sos(cfg.filtOrd, (cut_norm,), "lowpass")
    # corpus (bf16) mode runs the filter convs as bf16 multiplies with f32
    # accumulation too — consistent with the front-end's accuracy mode
    bf16 = spectrum == "matmul_bf16"
    if frame_lengths is None:
        filt = F.sosfiltfilt(sos, zi, padlen, traj, bf16=bf16)
        if cfg.diffMethod == "grad":
            diff = np_gradient(filt)  # spacing 1: np.gradient(..., axis=1)
        else:
            diff = savgol_filter_jax(filt, 3, 2, deriv=1)
    else:
        if masked_fir:
            design = F.design_filtfilt_operator(F._key_of(sos), padlen)
            mfiltfilt = jax.vmap(
                lambda tr, L: masked.masked_sosfiltfilt_fir(design, tr, L)
            )
        else:
            mfiltfilt = jax.vmap(
                lambda tr, L: masked.masked_sosfiltfilt(sos, zi, padlen, tr, L)
            )
        filt = mfiltfilt(traj, frame_lengths)
        if cfg.diffMethod == "grad":
            diff = jax.vmap(masked.masked_gradient)(filt, frame_lengths)
        else:
            diff = jax.vmap(
                lambda tr, L: masked.masked_savgol(tr, 3, 2, L, deriv=1)
            )(filt, frame_lengths)
    tot = jnp.sqrt(jnp.sum(diff * diff, axis=-2)) / n_coef
    if cfg.outFilter is None:
        if frame_lengths is None:
            tot = F.sosfiltfilt(sos, zi, padlen, tot, bf16=bf16)
        elif masked_fir:
            design = F.design_filtfilt_operator(F._key_of(sos), padlen)
            tot = jax.vmap(
                lambda tr, L: masked.masked_sosfiltfilt_fir(design, tr, L)
            )(tot, frame_lengths)
        else:
            tot = jax.vmap(
                lambda tr, L: masked.masked_sosfiltfilt(sos, zi, padlen, tr, L)
            )(tot, frame_lengths)
    else:
        if frame_lengths is None:
            tot = F.apply_filter(
                tot,
                fs_traj,
                filt=cfg.outFilter,
                cut_off=cfg.outFiltCutOff,
                filt_len=cfg.outFiltLen,
                filt_type=cfg.outFiltType,
                poly_ord=cfg.outFiltPolyOrd,
            )
        else:
            tot = _masked_apply_filter(
                tot, frame_lengths, fs_traj, cfg, masked_fir=masked_fir
            )
    return tot


def _masked_apply_filter(tot, frame_lengths, fs_traj, cfg: MfccConfig, *, masked_fir=False):
    """Length-masked version of the reference's out-filter stage
    (script/mfcc.py:423-425 → applyFilter)."""
    ftype = F.resolve_filt_type(cfg.outFiltType)
    cut = np.asarray([c for c in cfg.outFiltCutOff if c is not None], dtype=np.float64)
    wn = tuple((cut / (fs_traj / 2.0)).tolist())
    if cfg.outFilter == "iir":
        sos2, zi2, padlen2 = F.design_butter_sos(cfg.outFiltLen, wn, ftype)
        if masked_fir:
            design2 = F.design_filtfilt_operator(F._key_of(sos2), padlen2)
            return jax.vmap(
                lambda tr, L: masked.masked_sosfiltfilt_fir(design2, tr, L)
            )(tot, frame_lengths)
        return jax.vmap(
            lambda tr, L: masked.masked_sosfiltfilt(sos2, zi2, padlen2, tr, L)
        )(tot, frame_lengths)
    if cfg.outFilter == "fir":
        b, zi2, padlen2 = F.design_firwin(cfg.outFiltLen, wn, ftype)
        return jax.vmap(
            lambda tr, L: masked.masked_filtfilt(b, np.array([1.0]), zi2, padlen2, tr, L)
        )(tot, frame_lengths)
    if cfg.outFilter == "sg":
        return jax.vmap(
            lambda tr, L: masked.masked_savgol(
                tr, cfg.outFiltLen, cfg.outFiltPolyOrd, L, deriv=0
            )
        )(tot, frame_lengths)
    raise ValueError(f"Unknown outFilter {cfg.outFilter!r}")


def change_times(n_samples: int, cfg: MfccConfig) -> np.ndarray:
    """Host-side time anchors (reference script/mfcc.py:390)."""
    nf = n_frames_centered(n_samples, cfg.n_fft, cfg.hop_length)
    return frame_times_mfcc(nf, cfg.tStep, cfg.winLen)


@partial(jax.jit, static_argnames=("cfg", "use_fft", "spectrum"))
def _mfcc_change_jit(y, cfg, use_fft, spectrum):
    return mfcc_change(y, cfg, use_fft=use_fft, spectrum=spectrum)


@partial(jax.jit, static_argnames=("cfg", "use_fft", "spectrum", "masked_fir"))
def _mfcc_change_masked_jit(y, frame_lengths, cfg, use_fft, spectrum, masked_fir):
    return mfcc_change(
        y, cfg, frame_lengths=frame_lengths, use_fft=use_fft,
        spectrum=spectrum, masked_fir=masked_fir,
    )


@partial(jax.jit, static_argnames=("cfg", "use_fft", "spectrum"))
def _traj_masked_jit(y, frame_mask, cfg, use_fft, spectrum):
    return mfcc_trajectories(
        y, cfg, frame_mask=frame_mask, use_fft=use_fft, spectrum=spectrum
    )


def min_frames_for_fir(cfg: MfccConfig) -> int | None:
    """Minimum valid frame count for the masked FIR filter path (None when
    the operator probe declined, e.g. near-unstable designs)."""
    fs_traj = 1.0 / cfg.tStep
    cut_norm = cfg.filtCutoff / (fs_traj / 2.0)
    sos, _, padlen = F.design_butter_sos(cfg.filtOrd, (cut_norm,), "lowpass")
    d1 = F.design_filtfilt_operator(F._key_of(sos), padlen)
    if d1 is None:
        return None
    need = d1.min_len
    if cfg.outFilter is None:
        return need
    if cfg.outFilter != "iir":
        return None  # fir/sg out-filters use the scan/savgol masked forms
    ftype = F.resolve_filt_type(cfg.outFiltType)
    cut = np.asarray([c for c in cfg.outFiltCutOff if c is not None], dtype=np.float64)
    wn = tuple((cut / (fs_traj / 2.0)).tolist())
    sos2, _, padlen2 = F.design_butter_sos(cfg.outFiltLen, wn, ftype)
    d2 = F.design_filtfilt_operator(F._key_of(sos2), padlen2)
    if d2 is None:
        return None
    return max(need, d2.min_len)


def _host_trajectory_tail(m: np.ndarray, cfg: MfccConfig) -> np.ndarray:
    """The trajectory-rate tail on host with scipy (float64) — used for files
    too short for the FIR operator, where the device scan path's compile
    time would dwarf the microseconds of actual work. Bit-identical to the
    scipy calls the reference makes (script/mfcc.py:393-425)."""
    import scipy.signal as sps

    if cfg.removeFirst:
        m = m[:, 1:]
    traj = m.T.astype(np.float64)  # [n_coef, NF]
    fs_traj = 1.0 / cfg.tStep
    cut_norm = cfg.filtCutoff / (fs_traj / 2.0)
    sos = sps.butter(cfg.filtOrd, cut_norm, btype="low", output="sos")
    filt = sps.sosfiltfilt(sos, traj)
    if cfg.diffMethod == "grad":
        diff = np.gradient(filt, axis=1)
    else:
        diff = sps.savgol_filter(filt, 3, 2, deriv=1, axis=1, mode="interp")
    tot = np.sqrt(np.sum(diff**2, axis=0)) / traj.shape[0]
    if cfg.outFilter is None:
        return sps.sosfiltfilt(sos, tot)
    if cfg.outFilter == "iir":
        ftype = F.resolve_filt_type(cfg.outFiltType)
        cut = np.asarray([c for c in cfg.outFiltCutOff if c is not None])
        wn = cut / (fs_traj / 2.0)
        sos2 = sps.butter(cfg.outFiltLen, wn if wn.size > 1 else wn[0], btype=ftype, output="sos")
        return sps.sosfiltfilt(sos2, tot)
    if cfg.outFilter == "fir":
        ftype = F.resolve_filt_type(cfg.outFiltType)
        cut = np.asarray([c for c in cfg.outFiltCutOff if c is not None])
        b = sps.firwin(cfg.outFiltLen, cut / (fs_traj / 2.0), window=("kaiser", 7.4), pass_zero=ftype)
        return sps.filtfilt(b, 1.0, tot)
    if cfg.outFilter == "sg":
        return sps.savgol_filter(tot, cfg.outFiltLen, cfg.outFiltPolyOrd, deriv=0, mode="interp")
    raise ValueError(f"Unknown outFilter {cfg.outFilter!r}")


def extract_mfcc_change(
    y,
    cfg: MfccConfig = MfccConfig(),
    *,
    use_fft: bool = True,
    spectrum: str | None = None,
    bucket: int = 16_384,
    longform_threshold: int = 4_194_304,
):
    """User-facing: (tot_change, times) for one utterance or a batch.

    Drop-in functional replacement for the reference's Mfcc DataSource
    (script/main.py:726-770): same defaults, same outputs.

    Single utterances are zero-padded to a ``bucket`` multiple and processed
    through the masked pipeline, so ALL lengths within a bucket share one
    compiled program (per-length recompiles would make interactive use
    unusable). Files shorter than the
    FIR filter operator's minimum run the heavy spectral stage on device and
    the tiny 200 Hz-rate filter tail on host scipy (exact by construction).
    """
    y = jnp.asarray(y, dtype=jnp.float32)
    if y.ndim != 1:
        # batched input: exact-shape compile (corpus layers handle bucketing)
        tot = _mfcc_change_jit(y, cfg, use_fft, spectrum)
        return tot, change_times(y.shape[-1], cfg)
    n = y.shape[-1]
    from modulation_mfcc.utils.helpers import round_up_to_multiple

    if n >= longform_threshold:
        # hour-scale recordings: chunked streaming MFCC stage (lax.scan) so
        # the frame matrix never materializes (BASELINE.json config #4)
        from modulation_mfcc.parallel.streaming import chunked_mfcc_change

        tot = chunked_mfcc_change(y, cfg)
        return tot, change_times(n, cfg)
    t_pad = round_up_to_multiple(max(n, cfg.n_fft), bucket)
    nf_valid = 1 + n // cfg.hop_length
    ypad = jnp.pad(y, (0, t_pad - n))[None, :]
    t = change_times(n, cfg)
    mf = min_frames_for_fir(cfg)
    if mf is not None and nf_valid >= mf:
        fl = jnp.asarray([nf_valid], dtype=jnp.int32)
        tot = _mfcc_change_masked_jit(
            ypad, fl, cfg, use_fft, spectrum, True
        )
        return jnp.asarray(np.asarray(tot)[0, :nf_valid]), t
    nf_pad = n_frames_centered(t_pad, cfg.n_fft, cfg.hop_length)
    mask = (jnp.arange(nf_pad) < nf_valid).astype(jnp.float32)[None, :]
    m = _traj_masked_jit(ypad, mask, cfg, use_fft, spectrum)
    m_np = np.asarray(m)[0, :nf_valid, :].astype(np.float64)
    tot = _host_trajectory_tail(m_np, cfg)
    return jnp.asarray(tot), t


def extract_mfcc_matrix(
    y,
    cfg: MfccConfig = MfccConfig(),
    *,
    spectrum: str | None = None,
    bucket: int = 16_384,
):
    """(times, mfcc [NF, n_mfcc]) for one utterance — jitted and
    bucket-padded like extract_mfcc_change (one compile per bucket)."""
    from modulation_mfcc.utils.helpers import round_up_to_multiple

    y = jnp.asarray(y, dtype=jnp.float32)
    if y.ndim != 1:
        m = _traj_masked_jit(y, None, cfg, True, spectrum)
        return change_times(y.shape[-1], cfg), m
    n = y.shape[-1]
    t_pad = round_up_to_multiple(max(n, cfg.n_fft), bucket)
    nf_valid = 1 + n // cfg.hop_length
    nf_pad = n_frames_centered(t_pad, cfg.n_fft, cfg.hop_length)
    ypad = jnp.pad(y, (0, t_pad - n))[None, :]
    mask = (jnp.arange(nf_pad) < nf_valid).astype(jnp.float32)[None, :]
    m = _traj_masked_jit(ypad, mask, cfg, True, spectrum)
    return change_times(n, cfg), jnp.asarray(np.asarray(m)[0, :nf_valid])


def modulation_spectrum_axes(
    n_samples: int, cfg: MfccConfig, *, mod_n_fft: int = 128, mod_hop: int = 16
):
    """(mod_freqs [n_bins], mod_times [n_modframes]) for modulation_spectrum.

    Modulation frequency resolution is set by the trajectory rate 1/tStep
    (200 Hz default → bins up to 100 Hz modulation)."""
    fs_traj = 1.0 / cfg.tStep
    nf = n_frames_centered(n_samples, cfg.n_fft, cfg.hop_length)
    n_mod = 1 + nf // mod_hop
    freqs = np.linspace(0.0, fs_traj / 2.0, 1 + mod_n_fft // 2)
    times = frame_times_mfcc(nf, cfg.tStep, cfg.winLen)[
        np.minimum(np.arange(n_mod) * mod_hop, nf - 1)
    ]
    return freqs, times


def modulation_spectrum(
    y: jnp.ndarray,
    cfg: MfccConfig,
    *,
    mod_n_fft: int = 128,
    mod_hop: int = 16,
    use_fft: bool = True,
    spectrum: str | None = None,
) -> jnp.ndarray:
    """Second-stage STFT over MFCC coefficient trajectories.

    Returns the modulation power spectrum [..., n_coef, n_modframes, n_modbins]
    (BASELINE.json config 3): each MFCC coefficient trajectory (sampled at
    1/tStep Hz) is analyzed with a second Hann-windowed rFFT. Implemented as
    the same static framing+matmul pattern, batched over coefficients.
    ``spectrum`` selects the first-stage MFCC front-end like mfcc_change
    (e.g. 'matmul_bf16' for the corpus-throughput mode).
    """
    from modulation_mfcc.ops.spectral import analysis_window, power_spectrum_fft

    m = mfcc_trajectories(y, cfg, use_fft=use_fft, spectrum=spectrum)
    if cfg.removeFirst:
        m = m[..., 1:]
    traj = jnp.swapaxes(m, -1, -2)  # [..., n_coef, n_frames]
    traj = traj - jnp.mean(traj, axis=-1, keepdims=True)
    frames = frame_signal(traj, mod_n_fft, mod_hop)
    w = analysis_window(mod_n_fft, "hann", mod_n_fft)
    return power_spectrum_fft(frames, mod_n_fft, w)

