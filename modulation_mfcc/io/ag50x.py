"""Carstens AG50x electromagnetic articulograph (.pos) reader.

Replaces the reference's read_AG50x (script/calc.py:173-219; format per the
public adatool description of the AG50x binary layout): an ASCII header whose
second line gives its own byte size and which carries NumberOfChannels and
SamplingFrequency, followed by a float32 body of shape
[T, channels, 7 dims (x, z, y, phi, theta, rms, extra)].

Design difference: the reference resamples with a per-(channel, dim)
Python loop of scipy interp1d calls (calc.py:200-203); here the resampling is
ONE vectorized gather-lerp over all channels×dims on device
(ops-level ``linear_resample``), with extrapolation matching
interp1d(fill_value='extrapolate').
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["EmaData", "read_ag50x", "linear_resample"]

DIMS = ("x", "z", "y", "phi", "theta", "rms", "extra")

_CHANNEL_BLOCK = {8: 56, 16: 112, 32: 256}


@dataclass
class EmaData:
    """In-memory EMA recording (xarray-free equivalent of the reference's
    Dataset): ema [T, channels, 7], time [T], plus acquisition attrs."""

    ema: np.ndarray
    time: np.ndarray
    channels: np.ndarray
    dimensions: tuple = DIMS
    device: str = "AG50x"
    original_samplerate: int = 0
    resampled_samplerate: int = 0

    @property
    def duration(self) -> float:
        return float(self.time[-1]) if len(self.time) else 0.0

    def channel(self, idx: int, dim: str = "z") -> tuple[np.ndarray, np.ndarray]:
        """(time, values) of one channel/dimension — what the reference's
        generate_pos_curve plots (script/main.py:1337-1354 uses dim 'z')."""
        return self.time, self.ema[:, idx, DIMS.index(dim)]


@jax.jit
def linear_resample(values: jnp.ndarray, src_t: jnp.ndarray, dst_t: jnp.ndarray) -> jnp.ndarray:
    """Linear interpolation of values [T, ...] from src_t [T] onto dst_t [M],
    with linear extrapolation at both ends (interp1d fill_value='extrapolate').
    One fused gather-lerp for every trailing dimension."""
    t = values.shape[0]
    hi = jnp.clip(jnp.searchsorted(src_t, dst_t, side="left"), 1, t - 1)
    lo = hi - 1
    t0 = src_t[lo]
    t1 = src_t[hi]
    frac = (dst_t - t0) / jnp.maximum(t1 - t0, 1e-30)
    v0 = values[lo]
    v1 = values[hi]
    extra = (None,) * (values.ndim - 1)
    fr = frac[(...,) + extra]
    return v0 + fr * (v1 - v0)


def read_ag50x(path: str, target_sample_rate: int = 200) -> EmaData:
    """Parse + resample an AG50x .pos file (reference defaults: 200 Hz)."""
    with open(path, "rb") as f:
        content = f.read()
        f.seek(0)
        f.readline()
        header_size = int(f.readline().decode("utf8"))
    header = content[:header_size].decode("utf8").split("\n")
    n_channels = int(header[2].split("=")[1])
    ema_sr = int(header[3].split("=")[1])
    body = np.frombuffer(content[header_size:], np.float32)
    block = _CHANNEL_BLOCK[n_channels]
    body = body.reshape(-1, block)
    pos = body.reshape(len(body), -1, 7).astype(np.float64)

    src_t = np.linspace(0, len(pos) / ema_sr, len(pos))
    dst_t = np.arange(0, src_t[-1], 1.0 / target_sample_rate)
    out = np.asarray(
        linear_resample(
            jnp.asarray(pos), jnp.asarray(src_t), jnp.asarray(dst_t)
        )
    )
    return EmaData(
        ema=out,
        time=dst_t,
        channels=np.arange(pos.shape[1]),
        original_samplerate=ema_sr,
        resampled_samplerate=target_sample_rate,
    )


def write_ag50x(path: str, pos: np.ndarray, sample_rate: int) -> None:
    """Write a minimal AG50x-layout .pos file (mainly for tests/fixtures).

    pos: [T, channels, 7] float32; channels must be 8, 16 or 32.
    """
    n_channels = pos.shape[1]
    if n_channels not in _CHANNEL_BLOCK:
        raise ValueError(f"channels must be one of {sorted(_CHANNEL_BLOCK)}")
    block = _CHANNEL_BLOCK[n_channels]
    header_lines = [
        "AG50xDATA_V002",
        "{size}",
        f"NumberOfChannels={n_channels}",
        f"SamplingFrequencyHz={sample_rate}",
        "",
    ]
    # body rows are padded to the fixed per-format block size
    t = pos.shape[0]
    body = np.zeros((t, block), dtype=np.float32)
    body[:, : n_channels * 7] = pos.reshape(t, -1).astype(np.float32)
    # resolve the self-referential header size (line 2 states total bytes)
    for size_guess in range(40, 200):
        text = "\n".join(header_lines).format(size=size_guess)
        if len(text.encode("utf8")) == size_guess:
            break
    else:
        raise RuntimeError("could not fix header size")
    with open(path, "wb") as f:
        f.write(text.encode("utf8"))
        f.write(body.tobytes())
