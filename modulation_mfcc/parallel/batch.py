"""Padded/masked batching of variable-length audio + mesh-sharded execution.

The reference processes one file at a time on the GUI thread
(script/main.py:943); here corpus-scale extraction is a single jitted program
over a padded batch sharded on the mesh's ``data`` axis. Masking invariance
(padded-batch result == per-file result on valid frames) is a test gate
(SURVEY.md §4).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.models.modulation import mfcc_change
from modulation_mfcc.ops.framing import n_frames_centered
from modulation_mfcc.utils.helpers import round_up_to_multiple

__all__ = ["AudioBatch", "pad_batch", "batched_mfcc_change", "sharded_mfcc_change"]


@jax.tree_util.register_pytree_node_class
@dataclass
class AudioBatch:
    """A padded batch of utterances: samples [B, T_pad], lengths [B]."""

    samples: jnp.ndarray
    lengths: jnp.ndarray

    def tree_flatten(self):
        return (self.samples, self.lengths), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @property
    def batch_size(self) -> int:
        return self.samples.shape[0]


def dequantize_samples(samples: jnp.ndarray) -> jnp.ndarray:
    """Device-side int16→float32 PCM dequantization (no-op on floats).

    The corpus pipeline ships 16-bit-exact buckets over the host↔device
    link as int16 — HALF the transfer bytes of float32. x·2⁻¹⁵ is exact
    for every int16, so the converted batch is bit-identical to the
    float32 upload it replaces."""
    if jnp.issubdtype(samples.dtype, jnp.integer):
        return samples.astype(jnp.float32) * np.float32(2.0**-15)
    return samples


def pad_batch(
    signals: list[np.ndarray], *, bucket_multiple: int = 2048, dtype=np.float32
) -> AudioBatch:
    """Pad a list of 1-D signals to a shared bucketed length (static shapes →
    one compiled program per bucket, not per file)."""
    lengths = np.array([len(s) for s in signals], dtype=np.int32)
    t_pad = round_up_to_multiple(int(lengths.max()), bucket_multiple)
    out = np.zeros((len(signals), t_pad), dtype=dtype)
    for i, s in enumerate(signals):
        out[i, : len(s)] = s
    return AudioBatch(jnp.asarray(out), jnp.asarray(lengths))


def frame_validity_mask(lengths: jnp.ndarray, t_pad: int, cfg: MfccConfig) -> jnp.ndarray:
    """[B, n_frames] 1.0 where the frame index is a real frame of the
    unpadded signal (librosa frame count: 1 + len//hop for centered STFT)."""
    nf_pad = n_frames_centered(t_pad, cfg.n_fft, cfg.hop_length)
    nf_real = 1 + lengths // cfg.hop_length
    fidx = jnp.arange(nf_pad)[None, :]
    return (fidx < nf_real[:, None]).astype(jnp.float32)


def batched_mfcc_change(
    batch: AudioBatch,
    cfg: MfccConfig,
    *,
    use_fft: bool = True,
    spectrum: str | None = None,
    uniform_lengths: bool = False,
    masked_fir: bool = False,
    n_samples: int | None = None,
):
    """Masked batched modulation-cepstrum: returns (tot_change [B, NF],
    frame_mask [B, NF]). Exact per-file parity on valid frames (the filter
    edges use the length-masked variants, ops/masked.py).

    ``uniform_lengths=True`` (static) asserts every utterance fills the
    bucket, skipping the masked edge machinery — the fast path for
    fully-packed corpus buckets.

    3-D ``batch.samples`` = pre-laid-out hop rows [B, rows, hop]
    (``n_samples`` = the bucket's padded sample count then required): the
    corpus at-rest contract (ops/framing.pack_hop_rows) — the centered pad
    is already in place and int16 rows dequantize on device."""
    rows_in = batch.samples.ndim == 3
    if rows_in:
        if n_samples is None:
            raise ValueError("hop-rows batch requires n_samples")
        samples = batch.samples  # int16 rows dequantize in mfcc_change
        t_pad = int(n_samples)
    else:
        samples = dequantize_samples(batch.samples)
        t_pad = samples.shape[-1]
        n_samples = None
    mask = frame_validity_mask(batch.lengths, t_pad, cfg)
    if uniform_lengths:
        tot = mfcc_change(samples, cfg, use_fft=use_fft, spectrum=spectrum,
                          n_samples=n_samples)
        return tot, mask
    nf_real = 1 + batch.lengths // cfg.hop_length
    tot = mfcc_change(
        samples, cfg, frame_lengths=nf_real, use_fft=use_fft,
        spectrum=spectrum, masked_fir=masked_fir, n_samples=n_samples,
    )
    return tot, mask


@partial(jax.jit, static_argnames=("cfg", "use_fft", "mesh", "spectrum",
                                   "masked_fir"))
def _sharded_impl(samples, lengths, cfg, use_fft, mesh, spectrum, masked_fir):
    samples = jax.lax.with_sharding_constraint(
        samples, NamedSharding(mesh, P("data", None))
    )
    lengths = jax.lax.with_sharding_constraint(lengths, NamedSharding(mesh, P("data")))
    tot, mask = batched_mfcc_change(
        AudioBatch(samples, lengths), cfg, use_fft=use_fft,
        spectrum=spectrum, masked_fir=masked_fir,
    )
    # corpus-level stats ride an XLA all-reduce over the data axis
    n_frames = jnp.sum(mask)
    mean_change = jnp.sum(tot * mask) / jnp.maximum(n_frames, 1.0)
    return tot, mask, mean_change


def sharded_mfcc_change(
    batch: AudioBatch, cfg: MfccConfig, mesh, *, use_fft: bool = True,
    spectrum: str | None = None, masked_fir: bool = False,
):
    """Data-parallel extraction over the mesh's 'data' axis (pjit-style GSPMD:
    shardings annotated, collectives inserted by XLA)."""
    return _sharded_impl(
        batch.samples, batch.lengths, cfg, use_fft, mesh, spectrum, masked_fir,
    )
