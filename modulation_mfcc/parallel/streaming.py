"""Long-form ("long context") extraction: chunked streaming + time sharding.

The reference loads whole recordings into RAM and filters them in one
bidirectional pass (SURVEY.md §5: mfcc.py:373, sosfiltfilt), capping sequence
length at host memory. The long-form path (BASELINE.json config #4: 1-hour
48 kHz) splits the *sample* axis — where the memory and FLOPs are — while keeping the
tiny trajectory-rate (1/tStep Hz) recurrent stages exact:

  * ``chunked_mfcc_trajectories`` — a `lax.scan` over fixed-size sample
    chunks; each step slices the (hop-aligned) window needed for its frames,
    so peak memory is one chunk of frames, not the whole gathered [NF, n_fft]
    matrix. Frame-exact: MFCC frames depend only on their own n_fft window,
    so chunking introduces zero error.
  * ``sharded_longform_mfcc_change`` — shard_map over the mesh's 'time'
    axis: each device computes the MFCC frames of its sample shard (halo
    samples fetched from the right neighbor via `jax.lax.ppermute`), then the
    trajectory stages run on the all-gathered [n_coef, NF] matrix — at
    trajectory rate that is ~13 floats/frame, thousands of times smaller than
    the audio, so replicating the recurrent filter costs nothing while the
    FFT/mel/DCT FLOPs scale with devices.

Both paths reuse mfcc-change trajectory post-processing, so chunked ==
whole-file holds exactly (not just within a halo tolerance).
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.ops import filters as F
from modulation_mfcc.ops.derivatives import np_gradient
from modulation_mfcc.ops.savgol import savgol_filter_jax
from modulation_mfcc.ops.spectral import dct_matrix, melspectrogram

__all__ = [
    "chunked_mfcc_trajectories",
    "chunked_mfcc_change",
    "sharded_longform_mfcc_change",
]


def _chunk_frame_windows(n_samples: int, cfg: MfccConfig, frames_per_chunk: int):
    """Static chunk geometry for centered framing."""
    hop, n_fft = cfg.hop_length, cfg.n_fft
    pad = n_fft // 2
    nf = 1 + (n_samples + 2 * pad - n_fft) // hop
    n_chunks = -(-nf // frames_per_chunk)
    window = (frames_per_chunk - 1) * hop + n_fft
    return nf, n_chunks, window, pad


def chunked_mfcc_trajectories(
    y: jnp.ndarray, cfg: MfccConfig, *, frames_per_chunk: int = 4096,
    mel_stack_cap_bytes: int = 512 * 1024 * 1024,
) -> jnp.ndarray:
    """MFCCs [NF, n_mfcc] of a long 1-D signal via lax.scan over chunks.

    Numerically equal to the unchunked path except the per-utterance top_db
    clip, which needs the global mel max — computed in a first cheap pass
    (running max is associative, so it streams through the same scan).
    """
    from modulation_mfcc.ops.framing import frame_by_slices

    n = y.shape[-1]
    nf, n_chunks, window, pad = _chunk_frame_windows(n, cfg, frames_per_chunk)
    hop = cfg.hop_length
    ypad = jnp.pad(y, (pad, pad + n_chunks * frames_per_chunk * hop + window))
    starts = jnp.arange(n_chunks) * (frames_per_chunk * hop)

    def mel_of_chunk(start):
        # dynamic_slice to the chunk's (static-size) sample window, then
        # gather-free shifted-slice framing (an [fpc, n_fft] index gather
        # cost more than the chunk's FFTs at 1-hour scale)
        seg = jax.lax.dynamic_slice(ypad, (start,), (window,))
        frames = frame_by_slices(seg, 0, frames_per_chunk, cfg.n_fft, hop)
        return melspectrogram(
            frames,
            sr=cfg.signal_sample_rate,
            n_fft=cfg.n_fft,
            n_mels=cfg.n_mels,
            fmin=cfg.minFreq,
            fmax=cfg.maxFreq,
            win_length=cfg.win_length,
        )

    # librosa's per-utterance top_db clip needs the GLOBAL mel peak before
    # the db clip + DCT. Two exact schedules, chosen by static size:
    #   * single-pass (up to 512 MB of stacked mel — covers the 1-hour
    #     bench at 369 MB): one scan
    #     streams the mel chunks out while carrying the running peak; clip
    #     + DCT run on the stacked [NF, n_mels] result. NOTE the stack is
    #     n_mels/hop ≈ 1.6× the AUDIO size, not small — hence the cap.
    #   * two-pass (beyond the cap): the original peak-then-mfcc double
    #     scan, whose live memory is one chunk of mel — the bounded-memory
    #     schedule this module exists for (multi-hour streams).
    # Both compute identical numbers (same mel_of_chunk, same clip, same
    # HIGHEST DCT); only the schedule differs.
    d = jnp.asarray(dct_matrix(cfg.n_mfcc, cfg.n_mels), dtype=y.dtype)
    hi = jax.lax.Precision.HIGHEST
    # HIGHEST precision on the DCT matmuls: parity-grade like the
    # whole-file path's _pdot (ops/spectral.py) — a reduced-precision DCT
    # was once the entire 2.6e-4 chunked-vs-whole gap
    mel_stack_bytes = n_chunks * frames_per_chunk * cfg.n_mels * 4
    if mel_stack_bytes <= mel_stack_cap_bytes:
        def mel_step(carry, start):
            m = mel_of_chunk(start)
            fi = start // hop + jnp.arange(frames_per_chunk)
            valid = (fi < nf)[:, None]
            peak = jnp.max(jnp.where(valid, m, 0.0))
            return jnp.maximum(carry, peak), m

        peak, mels = jax.lax.scan(mel_step, jnp.asarray(0.0, y.dtype), starts)
        log_peak = 10.0 * jnp.log10(jnp.maximum(peak, 1e-10))
        db = 10.0 * jnp.log10(jnp.maximum(mels, 1e-10))
        db = jnp.maximum(db, log_peak - 80.0)
        out = jnp.matmul(db, d.T, precision=hi)
        return out.reshape(n_chunks * frames_per_chunk, cfg.n_mfcc)[:nf]

    def max_step(carry, start):
        m = mel_of_chunk(start)
        fi = start // hop + jnp.arange(frames_per_chunk)
        valid = (fi < nf)[:, None]
        peak = jnp.max(jnp.where(valid, m, 0.0))
        return jnp.maximum(carry, peak), None

    peak, _ = jax.lax.scan(max_step, jnp.asarray(0.0, y.dtype), starts)
    log_peak = 10.0 * jnp.log10(jnp.maximum(peak, 1e-10))

    def mfcc_step(_, start):
        m = mel_of_chunk(start)
        db = 10.0 * jnp.log10(jnp.maximum(m, 1e-10))
        db = jnp.maximum(db, log_peak - 80.0)
        return None, jnp.matmul(db, d.T, precision=hi)

    _, out = jax.lax.scan(mfcc_step, None, starts)
    return out.reshape(n_chunks * frames_per_chunk, cfg.n_mfcc)[:nf]


def _trajectory_postprocess(m: jnp.ndarray, cfg: MfccConfig) -> jnp.ndarray:
    """Shared trajectory-rate tail of the modulation pipeline: drop C0,
    low-pass, derivative, norm, final filter (script/mfcc.py:393-425)."""
    if cfg.removeFirst:
        m = m[..., 1:]
    n_coef = m.shape[-1]
    traj = jnp.swapaxes(m, -1, -2)
    fs_traj = 1.0 / cfg.tStep
    cut_norm = cfg.filtCutoff / (fs_traj / 2.0)
    sos, zi, padlen = F.design_butter_sos(cfg.filtOrd, (cut_norm,), "lowpass")
    filt = F.sosfiltfilt(sos, zi, padlen, traj)
    if cfg.diffMethod == "grad":
        diff = np_gradient(filt)
    else:
        diff = savgol_filter_jax(filt, 3, 2, deriv=1)
    tot = jnp.sqrt(jnp.sum(diff * diff, axis=-2)) / n_coef
    if cfg.outFilter is None:
        tot = F.sosfiltfilt(sos, zi, padlen, tot)
    else:
        tot = F.apply_filter(
            tot,
            fs_traj,
            filt=cfg.outFilter,
            cut_off=cfg.outFiltCutOff,
            filt_len=cfg.outFiltLen,
            filt_type=cfg.outFiltType,
            poly_ord=cfg.outFiltPolyOrd,
        )
    return tot


@partial(jax.jit, static_argnames=("cfg", "frames_per_chunk", "mel_stack_cap_bytes"))
def chunked_mfcc_change(
    y: jnp.ndarray, cfg: MfccConfig, *, frames_per_chunk: int = 4096,
    mel_stack_cap_bytes: int = 512 * 1024 * 1024,
) -> jnp.ndarray:
    """Long-form modulation cepstrum [NF] — streaming MFCC stage, exact
    trajectory tail (the trajectory is ~3 orders of magnitude smaller than
    the audio, so it never needs chunking)."""
    m = chunked_mfcc_trajectories(
        y, cfg, frames_per_chunk=frames_per_chunk,
        mel_stack_cap_bytes=mel_stack_cap_bytes,
    )
    return _trajectory_postprocess(m, cfg)


def sharded_longform_mfcc_change(y: jnp.ndarray, cfg: MfccConfig, mesh) -> jnp.ndarray:
    """Time-sharded long-form extraction (sequence parallelism with halos).

    The signal [T] is split evenly over the mesh's 'time' axis. Each device
    frames its shard plus a right halo of n_fft samples ppermuted from the
    next device, computes local MFCC frames, then the tiny trajectory matrix
    is all-gathered and post-processed identically on every device.
    """
    n_t = mesh.shape["time"]
    t_true = y.shape[-1]
    hop, n_fft = cfg.hop_length, cfg.n_fft
    pad = n_fft // 2
    nf_total = 1 + t_true // hop
    # frames per shard (last shard may own fewer; masked at gather)
    fps = -(-nf_total // n_t)
    # arbitrary lengths: zero-pad the sample axis to a shardable multiple;
    # frame ownership/validity below is in true-sample coordinates, so the
    # tail padding behaves exactly like centered framing's zero extension
    t = -(-t_true // n_t) * n_t
    if t != t_true:
        y = jnp.pad(y, (0, t - t_true))
    shard_len = t // n_t
    # Exact static halo: the right overhang of a shard's frame windows grows
    # with shard index (frame ownership is by frame count, sample ownership
    # by sample count), maximal at the last shard. Only this slice — not the
    # whole neighbor shard — rides the ppermute.
    max_off = (n_t - 1) * (fps * hop - shard_len)  # worst first-window drift
    halo_r = max(0, max_off + (fps - 1) * hop + n_fft - shard_len)
    halo_r = min(max(halo_r, hop), shard_len)

    def local_frames(shard, shard_id):
        # global sample start of this shard's first frame window
        # frame f starts at f*hop - pad in signal coords
        first_frame = shard_id * fps
        # bring in neighbor halos: the next shard's head covers our last
        # frame windows; the previous shard's tail covers the centered pad
        nbr = jax.lax.ppermute(
            shard[..., :halo_r], "time", [(i, (i - 1) % n_t) for i in range(n_t)]
        )
        left_nbr = jax.lax.ppermute(
            shard[..., -pad:], "time", [(i, (i + 1) % n_t) for i in range(n_t)]
        )
        ext = jnp.concatenate([left_nbr, shard, nbr], axis=-1)
        # position of global sample (shard_id*shard_len) in ext is pad
        # frame f (global) needs ext[(f - first... ) ...]
        local_start0 = first_frame * hop - pad  # in signal coords
        shard_start = shard_id * shard_len
        off = local_start0 - shard_start + pad  # index in ext of first window
        fidx = off + np.arange(fps)[:, None] * hop + np.arange(n_fft)[None, :]
        fidx = jnp.clip(fidx, 0, ext.shape[-1] - 1)
        frames = ext[fidx]
        # zero out-of-range (head of device 0: the centered left zero-pad)
        sample_pos = off + shard_start - pad + np.arange(fps)[:, None] * hop + np.arange(n_fft)[None, :]
        valid = (sample_pos >= 0) & (sample_pos < t_true)
        return jnp.where(valid, frames, 0.0)

    def step(shard):
        shard_id = jax.lax.axis_index("time")
        frames = local_frames(shard, shard_id)
        mel = melspectrogram(
            frames,
            sr=cfg.signal_sample_rate,
            n_fft=cfg.n_fft,
            n_mels=cfg.n_mels,
            fmin=cfg.minFreq,
            fmax=cfg.maxFreq,
            win_length=cfg.win_length,
        )
        # librosa's top_db clip needs the *global* mel-db max: one scalar
        # pmax collective over the time axis makes the sharded output exact.
        fi = shard_id * fps + jnp.arange(fps)
        valid = (fi < nf_total)[:, None]
        local_db_peak = jnp.max(
            jnp.where(valid, 10.0 * jnp.log10(jnp.maximum(mel, 1e-10)), -jnp.inf)
        )
        peak = jax.lax.pmax(local_db_peak, "time")
        db = jnp.maximum(10.0 * jnp.log10(jnp.maximum(mel, 1e-10)), peak - 80.0)
        d = jnp.asarray(dct_matrix(cfg.n_mfcc, cfg.n_mels), dtype=db.dtype)
        m = jnp.matmul(db, d.T, precision=jax.lax.Precision.HIGHEST)
        all_m = jax.lax.all_gather(m, "time", axis=0)  # [n_t, fps, n_mfcc]
        all_m = all_m.reshape(n_t * fps, cfg.n_mfcc)[:nf_total]
        return _trajectory_postprocess(all_m, cfg)

    fn = jax.shard_map(
        step, mesh=mesh, in_specs=P("time"), out_specs=P(), check_vma=False
    )
    return fn(y)
