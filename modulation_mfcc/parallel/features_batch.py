"""Batched (padded + vmapped) extraction for the non-MFCC features.

The reference computes every feature one file at a time on the GUI thread;
the modulation pipeline already has a first-class batched path
(parallel/batch.py). This module gives F0, amplitude envelope and formants
the same treatment: one compiled program per bucket, `jax.vmap` over the
batch, per-utterance validity masks on the outputs.

Accuracy notes:
  * envelope (RMS): exact per-file parity — RMS frames are local, padding
    zeros only land in invalid frames.
  * F0: frames are local, but the Viterbi path is decoded over the padded
    frame range; padded frames are strongly unvoiced so the path over the
    valid region matches the single-file decode except occasionally at the
    final voiced/padding boundary (tolerance-grade, like the tracker
    itself).
  * formants: per-frame LPC is local → exact on valid frames; the intensity
    gate is computed per item.
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from modulation_mfcc.models.config import AmplitudeConfig, F0Config, FormantConfig
from modulation_mfcc.ops.lpc import lpc_formants
from modulation_mfcc.ops.pitch import pitch_ac
from modulation_mfcc.parallel.batch import AudioBatch

__all__ = ["batched_f0", "batched_envelope", "batched_formants"]


@partial(jax.jit, static_argnames=("sr", "cfg"))
def _pyin_impl(samples, sr, cfg: F0Config):
    from modulation_mfcc.ops.yin import pyin_f0

    return jax.vmap(
        lambda y: pyin_f0(
            y,
            sr=sr,
            fmin=float(cfg.minPitch),
            fmax=float(cfg.maxPitch),
            frame_length=cfg.pyinframe_length,
            win_length=cfg.pyinwin_length,
            hop=cfg.hopSize,
            n_thresholds=cfg.n_thresholds,
            beta_parameters=cfg.beta_parameters,
            boltzmann_parameter=cfg.boltzmann_parameter,
            resolution=cfg.resolution,
            max_transition_rate=cfg.max_transition_rate,
            switch_prob=cfg.switch_prob,
            no_trough_prob=cfg.no_trough_prob,
            center=cfg.pyincenter,
            pad_mode=cfg.pyinpad_mode,
        )
    )(samples)


@partial(jax.jit, static_argnames=("sr", "cfg"))
def _f0_impl(samples, lengths, sr, cfg: F0Config):
    method = "ac" if cfg.method == "praatac" else "cc"
    return jax.vmap(
        lambda y, L: pitch_ac(
            y,
            valid_len=L,
            sr=sr,
            hop=cfg.hopSize,
            min_pitch=float(cfg.minPitch),
            max_pitch=float(cfg.maxPitch),
            max_cand=cfg.maxCandNum,
            method=method,
            silence_thresh=cfg.silenceThresh,
            voicing_thresh=cfg.voicingThresh,
            octave_cost=cfg.octaveCost,
            octave_jump_cost=cfg.octaveJumpCost,
            voiced_unvoiced_cost=cfg.voicedUnvoicedCost,
            very_accurate=bool(cfg.veryAccurate),
        )
    )(samples, lengths)


def batched_f0(batch: AudioBatch, sr: float, cfg: F0Config = F0Config()):
    """(f0 [B, NF], valid [B, NF]) — raw tracks, 0 = unvoiced.

    Post-processing (NaN interp, filtering) is host-side per file like
    extract_f0; this provides the heavy tracking stage at corpus scale.
    Supports praatac/praatcc (autocorrelation tracker) and pyin: pyin's
    centered constant padding equals the batch's zero padding, so its
    frames are exact on the valid range (the Viterbi decode still sees the
    padded tail — tolerance-grade at the final boundary, like ac/cc).
    With pyinpad_mode != 'constant' the tail frames see batch zeros instead
    of the reflected/edge extension — use the per-file path for those.
    """
    hop_s = max(1, int(round(cfg.hopSize * sr)))
    if cfg.method == "pyin":
        f0 = _pyin_impl(batch.samples, float(sr), cfg)
        nf = f0.shape[-1]
        nf_real = jnp.minimum(1 + batch.lengths // hop_s, nf)
        valid = jnp.arange(nf)[None, :] < nf_real[:, None]
        return jnp.where(valid, f0, 0.0), valid
    f0 = _f0_impl(batch.samples, batch.lengths, float(sr), cfg)
    nf = f0.shape[-1]
    periods = (6.0 if cfg.veryAccurate else 3.0) if cfg.method == "praatac" else 1.0
    nw = int(round(periods / cfg.minPitch * sr))
    span = nw if cfg.method == "praatac" else nw + int(np.ceil(sr / cfg.minPitch))
    # frames whose analysis span lies fully inside the utterance
    nf_real = jnp.maximum(1 + (batch.lengths - span) // hop_s, 0)
    valid = jnp.arange(nf)[None, :] < nf_real[:, None]
    return jnp.where(valid, f0, 0.0), valid


@partial(jax.jit, static_argnames=("sr", "cfg"))
def _env_impl(samples, lengths, sr, cfg: AmplitudeConfig):
    from modulation_mfcc.models.envelope import rms_envelope

    fr_len = int(cfg.hopLen * sr)
    win_len = int(cfg.winLen * sr)
    amp = rms_envelope(samples, win_len, fr_len, center=cfg.center)
    nf = amp.shape[-1]
    nf_real = 1 + lengths // fr_len
    valid = jnp.arange(nf)[None, :] < nf_real[:, None]
    return jnp.where(valid, amp, 0.0), valid


@partial(jax.jit, static_argnames=("cfg",))
def _hilb_impl(samples, lengths, cfg: AmplitudeConfig):
    from modulation_mfcc.ops.hilbert import hilbert_envelope

    amp = hilbert_envelope(samples)  # dense [B, W]
    valid = jnp.arange(samples.shape[-1])[None, :] < lengths[:, None]
    return jnp.where(valid, amp, 0.0), valid


def batched_envelope(batch: AudioBatch, sr: float, cfg: AmplitudeConfig = AmplitudeConfig()):
    """(amp [B, NF], valid [B, NF]).

    * 'RMS'  — exact per-file parity (frames are local).
    * 'Hilb' — analytic signal over the zero-padded batch width: the FFT is
      global, so values differ from the per-file transform by edge ripple
      that decays away from the valid/pad boundary (tolerance-grade tail,
      exact-grade interior). Output is dense per-sample.
    * 'RMSpraat' picks its own output rate per file (pitch-adaptive) — use
      the per-file extract_envelope path.
    """
    if cfg.method == "RMS":
        return _env_impl(batch.samples, batch.lengths, float(sr), cfg)
    if cfg.method == "Hilb":
        return _hilb_impl(batch.samples, batch.lengths, cfg)
    raise ValueError(
        "batched_envelope supports method='RMS' or 'Hilb' "
        "(RMSpraat is per-file adaptive; use extract_envelope)"
    )


@partial(jax.jit, static_argnames=("sr", "cfg"))
def _formant_impl(samples, sr, cfg: FormantConfig):
    order = 2 * cfg.max_num_formants
    freqs, bw = jax.vmap(
        lambda y: lpc_formants(
            y,
            sr=sr,
            order=order,
            window_length=cfg.window_length,
            time_step=cfg.time_step,
            pre_emphasis_from=cfg.pre_emphasis_from,
            max_formant=cfg.max_formant,
        )
    )(samples)
    return freqs, bw


def batched_formants(batch_resampled: jnp.ndarray, sr: float, cfg: FormantConfig = FormantConfig()):
    """(freqs [B, NF, n_formants], bandwidths) for a batch already resampled
    to 2×max_formant (host-side polyphase, see models/formants.py)."""
    return _formant_impl(batch_resampled, float(sr), cfg)
