"""Every spectrum tier × every input form against the float64 oracle.

The tiers (ops/spectral.SPECTRA) are judged at the deliverable surface —
``get_MFCCS_change`` — on int16-origin speech-like audio (the corpus upload
format, i16's exactness domain), through the three input forms users send:

  * flat     — one utterance [1, T] through ``mfcc_change``;
  * masked   — a padded batch of two lengths through ``batched_mfcc_change``
               (masked FIR edges), each row against its own oracle;
  * rows     — the same batch at rest as int16 hop rows.

Tolerances are each tier's stated bar: 5e-5 for the f32-grade tiers
(matmul, i24, i16), 1e-4 for x3, 1e-1 for the bf16 corpus tier.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.ops.framing import pack_hop_rows
from modulation_mfcc.oracle import get_mfccs_change_np
from modulation_mfcc.parallel.batch import AudioBatch, batched_mfcc_change

SR = 16_000
CFG = MfccConfig(signal_sample_rate=SR, maxFreq=8000.0)
TOL = {"matmul": 5e-5, "matmul_x3": 1e-4, "matmul_bf16": 1e-1,
       "matmul_i24": 5e-5, "matmul_i16": 5e-5}
LENGTHS = (int(4.4 * SR), int(3.9 * SR))  # both above the FIR operator's 744 frames


def _speech(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 200) * (1.0 + 0.15 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    sig = sum((0.5 / k) * np.sin(k * phase) for k in range(1, 6))
    sig = 0.6 * sig * 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 6) * t))
    sig = sig + 0.01 * rng.standard_normal(n)
    return np.round(np.clip(sig, -1, 32767 / 32768) * 32768).astype(np.int16)


@pytest.fixture(scope="module")
def corpus():
    pcm = [_speech(n, 30 + i) for i, n in enumerate(LENGTHS)]
    want = [
        get_mfccs_change_np(p.astype(np.float64) / 32768.0, SR, max_freq=8000.0)[0]
        for p in pcm
    ]
    t_pad = max(LENGTHS)
    buf = np.zeros((len(pcm), t_pad), np.int16)
    for i, p in enumerate(pcm):
        buf[i, : len(p)] = p
    return pcm, want, buf


def _masked(samples, spectrum, n_samples=None):
    lengths = jnp.asarray(LENGTHS, jnp.int32)
    tot, _ = batched_mfcc_change(
        AudioBatch(samples, lengths), CFG, spectrum=spectrum, masked_fir=True,
        n_samples=n_samples,
    )
    return np.asarray(tot)


@pytest.mark.parametrize("form", ["flat", "masked", "rows"])
@pytest.mark.parametrize("spectrum", list(TOL))
def test_tier_parity_vs_oracle(corpus, spectrum, form):
    from modulation_mfcc.models.modulation import mfcc_change

    pcm, want, buf = corpus
    if form == "flat":
        y = jnp.asarray(pcm[0].astype(np.float32) / 32768.0)[None]
        rows_out = [np.asarray(mfcc_change(y, CFG, spectrum=spectrum))[0]]
    elif form == "masked":
        rows_out = list(_masked(jnp.asarray(buf), spectrum))
    else:
        rows = jnp.asarray(pack_hop_rows(buf, n_fft=CFG.n_fft, hop=CFG.hop_length))
        rows_out = list(_masked(rows, spectrum, n_samples=buf.shape[-1]))
    for got, ref in zip(rows_out, want):
        err = np.abs(got[: ref.shape[0]] - ref).max()
        assert err < TOL[spectrum], (spectrum, form, err)
