"""Precision tiers of the DFT-as-matmul front-end (ops/spectral.py).

Each tier is a fixed arithmetic — f32 HIGHEST, bf16 x3 split, one bf16
pass, 24- and 16-bit int8 digit planes — whose error budget these tests
pin against the rfft path and the float64 oracle. The hop-rows at-rest
contract (ops/framing.pack_hop_rows) must reproduce the flat path bitwise.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.models.modulation import mfcc_change, mfcc_trajectories
from modulation_mfcc.ops.framing import frame_signal, pack_hop_rows
from modulation_mfcc.ops.spectral import mfcc_from_frames

CFG16 = MfccConfig(signal_sample_rate=16_000, maxFreq=8000.0)


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(20260816)
    return jnp.asarray(rng.standard_normal((2, 24_000)), dtype=jnp.float32)


def _reference(a, sr=16_000.0, hop=80):
    return mfcc_from_frames(
        frame_signal(a, 512, hop), sr=sr, n_fft=512, win_length=400,
        fmin=100.0, fmax=8000.0,
    )


def _tier_mfcc(a, spectrum, cfg=CFG16, **kw):
    return np.asarray(mfcc_trajectories(a, cfg, spectrum=spectrum, **kw))


def test_fused_mfcc_interpret_matches_oracle(audio):
    """'matmul' (f32 HIGHEST) == the rfft path to 1e-4 at the MFCC level."""
    want = np.asarray(_reference(audio))
    got = _tier_mfcc(audio, "matmul")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_fused_mfcc_single_utterance(audio):
    got = _tier_mfcc(audio[0], "matmul")
    want = np.asarray(_reference(audio[0]))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_spectrum_option_dispatch(audio):
    via_opt = _tier_mfcc(audio, "matmul")
    direct = _tier_mfcc(audio, "fft")
    np.testing.assert_allclose(via_opt, direct, atol=1e-4)


def test_bf16_mode_accuracy_contract():
    """The corpus (bf16) mode's contract is on the *modulation-change
    output* (what the sweep computes); bound 1e-1.

    Deliberately NOT a raw-MFCC bound: single-pass bf16 DFT has an absolute
    error floor ~40 dB below each frame's energy, so quiet mel bins of
    high-dynamic-range material show tens of dB of error in corpus mode —
    the downstream norm-over-coefficients + filtering is what makes the
    pipeline output robust. Parity-critical work must use the f32 tier."""
    sr = 16_000
    rng = np.random.default_rng(0)
    t = np.arange(int(1.5 * sr)) / sr
    y = sum((0.6 / k) * np.sin(2 * np.pi * k * 140 * t) for k in range(1, 6))
    y = y * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    y = y + 1e-2 * rng.standard_normal(len(t))  # -40 dB floor, typical recording
    y = jnp.asarray(y, dtype=jnp.float32)[None, :]
    want = np.asarray(mfcc_change(y, CFG16, spectrum="fft"))
    got = np.asarray(mfcc_change(y, CFG16, spectrum="matmul_bf16"))
    err = np.abs(got - want).max()
    assert err < 1e-1, err
    assert err > 1e-6  # sanity: this IS the reduced-precision mode


def test_fused_mfcc_packed_nyquist(audio):
    """fmax > Nyquist (the reference's 10 kHz default) keeps every bin live,
    the Nyquist bin included — the trimmed-bin bases must stay exact."""
    sr, hop = 10_000.0, 50
    want = np.asarray(
        mfcc_from_frames(
            frame_signal(audio, 512, hop), sr=sr, n_fft=512, win_length=250,
            fmin=100.0, fmax=10_000.0,
        )
    )
    got = _tier_mfcc(audio, "matmul", MfccConfig())
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_x3_mode_accuracy_contract(audio):
    """spectrum='matmul_x3': ~1e-3-grade MFCC error (2^-17 operand split),
    between the f32 parity mode and the bf16 corpus mode."""
    want = _tier_mfcc(audio, "fft")
    got = _tier_mfcc(audio, "matmul_x3")
    err = np.abs(got - want).max()
    assert err < 2e-2, err
    assert err > 1e-6  # sanity: reduced-precision mode, not the f32 path


def test_fused_mfcc_masked_peak(audio):
    """frame_mask restricts the top_db peak to valid frames: a masked row
    equals the unmasked MFCC of its own prefix (the clip floor follows the
    valid frames' peak only)."""
    nf = 1 + audio.shape[-1] // 80
    mask = np.ones((2, nf), np.float32)
    mask[1, nf // 2 :] = 0.0
    got = _tier_mfcc(audio, "matmul", frame_mask=jnp.asarray(mask))
    assert np.all(np.isfinite(got))
    n_keep = (nf // 2 - 1) * 80
    prefix = _tier_mfcc(audio[1, :n_keep], "matmul")
    k = prefix.shape[0] - 4  # frames whose windows lie inside the prefix
    np.testing.assert_allclose(got[1, :k], prefix[:k], atol=1e-4)


def test_x3_end_to_end_error_budget():
    """Certify the tiers at the DELIVERABLE surface (get_MFCCS_change):
    while x3's MFCC-stage error is ~1e-3, the modulation-output error on
    real-statistics audio must stay within the 1e-4 parity bar — the
    norm-over-coefficients and the 12 Hz low-pass average the DFT rounding
    noise down ~two orders."""
    from modulation_mfcc.oracle import get_mfccs_change_np

    rng = np.random.default_rng(20260816)
    sr = 16_000
    t = np.arange(int(2.0 * sr)) / sr
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 2.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    sig = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t - np.pi / 2))
    sig = (sig * env + 0.01 * rng.standard_normal(len(t))).astype(np.float32)

    want, _ = get_mfccs_change_np(sig.astype(np.float64), sr, max_freq=8000.0)
    for spec, bound in (("matmul", 5e-5), ("matmul_i24", 5e-5), ("matmul_x3", 1e-4)):
        got = np.asarray(mfcc_change(jnp.asarray(sig), CFG16, spectrum=spec))
        assert np.abs(got - want).max() < bound, spec


def test_i24_matches_f32_grade(audio):
    """The fixed-point i24 tier (int8 digit-plane DFT) must hold f32-grade
    MFCC parity: within the same 1e-4 band as the f32 tier vs the rfft
    path on the noise fixture."""
    want = np.asarray(_reference(audio))
    got = _tier_mfcc(audio, "matmul_i24")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_i16_matches_f32_grade_on_int16_audio():
    """'matmul_i16' (two int8 audio digits + offset-corrected low digit)
    must hold f32-grade MFCC parity on int16-PCM-origin audio — the
    tier's exactness domain. Weight quantization (2^-24·max|W|) is the
    only approximation, same class as i24."""
    rng = np.random.default_rng(20260818)
    pcm = rng.integers(-32768, 32768, (2, 24_000)).astype(np.int16)
    a = jnp.asarray(pcm.astype(np.float32) / 32768.0)
    want = np.asarray(_reference(a))
    np.testing.assert_allclose(_tier_mfcc(a, "matmul_i16"), want, atol=1e-4)


def test_i16_quiet_audio_per_utterance_scale():
    """i16 must stay f32-grade on QUIET int16 material too: a fixed
    s = 32768 would quantize a −60 dBFS utterance at full-scale-absolute
    step size (~3e-2 at the MFCC surface) — fixed by the per-utterance
    power-of-two scale (each batch row gets its OWN scale; the exactness
    property, x·s integral for int16-origin PCM at any level, survives the
    scaling). The scale must be a true power of two (frexp/ldexp; f32
    exp2/log2 are inexact at integer points on XLA backends). This fixture
    also makes x0s ≡ −128 (X is an exact multiple of 256), the worst data
    case for the dropped x0s·w0 digit term, bounding it here.

    The strict bar is RELATIVE error at the MEL surface vs a float64
    oracle (2e-4; one worst-case mel at that level is ≤ 4.34·2e-4·0.125
    ≈ 1e-4 per MFCC coefficient). At the MFCC surface quiet audio drives
    every mel-dB to ~−60, so |c0| ≈ 679 where the f32 ulp is 6e-5 and a
    128-term f32 dot wobbles ~3e-4 for ANY f32 pipeline — hence 5e-4
    there, still far below the 2.2e-3/3e-2 regression classes."""
    from modulation_mfcc.ops.spectral import (
        dft_bases,
        mel_filterbank,
        tier_bases,
        tier_mel,
        tier_scale,
    )

    rng = np.random.default_rng(7)
    loud = rng.integers(-32768, 32768, 24_000)
    quiet = rng.integers(-33, 34, 24_000)  # ~-60 dBFS
    pcm = np.stack([loud, quiet]).astype(np.int16)
    a64 = pcm.astype(np.float64) / 32768.0
    a = jnp.asarray(a64.astype(np.float32))
    nf = 1 + 24_000 // 80
    pw, wri, mel_t = tier_bases(16_000.0, 512, 400, 128, 100.0, 8000.0)
    yp = jnp.pad(a, ((0, 0), (256, 256)))
    frames = frame_signal(a, 512, 80)[..., pw : pw + 400]
    mel = np.asarray(
        tier_mel(frames, "matmul_i16", wri, mel_t, tier_scale("matmul_i16", yp)),
        np.float64,
    )
    # float64 oracle mel (centered framing, windowed-DFT bases, Slaney mel)
    wr, wi = dft_bases(512, "hann", 400)
    m = mel_filterbank(16_000.0, 512, 128, 100.0, 8000.0)
    pad = np.pad(a64, ((0, 0), (256, 256)))
    fr = np.stack([[pad[r, i * 80 : i * 80 + 512] for i in range(nf)]
                   for r in range(2)])
    want_mel = ((fr @ wr) ** 2 + (fr @ wi) ** 2) @ m.T
    rel = (mel - want_mel) / np.maximum(np.abs(want_mel), 1e-300)
    assert np.abs(rel).max() <= 2e-4
    np.testing.assert_allclose(
        _tier_mfcc(a, "matmul_i16"), np.asarray(_reference(a)), atol=5e-4
    )


def test_i16_public_spectrum_dispatch():
    """spectrum='matmul_i16' through mfcc_change gives parity-grade output
    on int16-origin speechlike audio."""
    from modulation_mfcc.oracle import get_mfccs_change_np

    sr = 16_000
    t = np.arange(int(1.5 * sr)) / sr
    sig = 0.4 * np.sin(2 * np.pi * 150 * t) + 0.2 * np.sin(2 * np.pi * 900 * t)
    pcm = np.round(sig * 32767).astype(np.int16)
    a = pcm.astype(np.float32) / 32768.0
    want, _ = get_mfccs_change_np(a.astype(np.float64), sr, max_freq=8000.0)
    got = np.asarray(mfcc_change(jnp.asarray(a), CFG16, spectrum="matmul_i16"))
    assert np.abs(got - want).max() < 5e-5


# ---------------------------------------------------------------------------
# Hop-rows at-rest contract: pre-padded hop rows [B, rows_total, hop] are
# reshaped back to the centered-padded flat audio on device; int16 rows
# dequantize by the exact 2⁻¹⁵.


@pytest.fixture(scope="module")
def pcm16():
    rng = np.random.default_rng(20260819)
    return (rng.standard_normal((2, 24_000)) * 8000.0).astype(np.int16)


def _rows_and_flat(pcm):
    rows = pack_hop_rows(pcm, n_fft=512, hop=80)
    flat = jnp.asarray(pcm.astype(np.float32) * np.float32(2.0**-15))
    return jnp.asarray(rows), flat


@pytest.mark.parametrize("algo", ["matmul", "matmul_x3", "matmul_i24", "matmul_i16"])
def test_rows_input_bitwise_matches_flat(pcm16, algo):
    """int16 rows == flat f32 BITWISE for every tier: the dequant v·2⁻¹⁵
    is exact and the rows already hold the centered pad, so every op sees
    identical values."""
    rows, flat = _rows_and_flat(pcm16)
    t = pcm16.shape[-1]
    got = _tier_mfcc(rows, algo, n_samples=t)
    want = _tier_mfcc(flat, algo)
    assert np.array_equal(got, want)


def test_rows_input_f32_rows_bitwise(pcm16):
    """f32 rows (arbitrary float audio pre-packed) == flat, bitwise."""
    flat = pcm16.astype(np.float32) * np.float32(2.0**-15)
    rows = jnp.asarray(pack_hop_rows(flat, n_fft=512, hop=80))
    got = _tier_mfcc(rows, "matmul_i24", n_samples=flat.shape[-1])
    want = _tier_mfcc(jnp.asarray(flat), "matmul_i24")
    assert np.array_equal(got, want)


def test_rows_input_bf16_within_mode_tolerance(pcm16):
    """bf16 rows sit within the mode's error envelope of the f32 result,
    and equal the flat bf16 path (the bf16 cast is elementwise)."""
    rows, flat = _rows_and_flat(pcm16)
    t = pcm16.shape[-1]
    got = _tier_mfcc(rows, "matmul_bf16", n_samples=t)
    via_flat = _tier_mfcc(flat, "matmul_bf16")
    exact = _tier_mfcc(flat, "matmul")
    assert np.max(np.abs(got - exact)) <= np.max(np.abs(via_flat - exact)) + 0.1
    np.testing.assert_allclose(got, via_flat, atol=0.5)


def test_rows_input_masked_mfcc_change(pcm16):
    """End-to-end masked corpus path on rows: mfcc_change(rows, …,
    frame_lengths) == mfcc_change(flat, …, frame_lengths) bitwise."""
    rows, flat = _rows_and_flat(pcm16)
    t = pcm16.shape[-1]
    lengths = jnp.asarray([1 + (t - 4000) // 80, 1 + t // 80], jnp.int32)
    got = mfcc_change(rows, CFG16, frame_lengths=lengths,
                      spectrum="matmul_i16", n_samples=t)
    want = mfcc_change(flat, CFG16, frame_lengths=lengths,
                       spectrum="matmul_i16")
    assert np.array_equal(np.asarray(got), np.asarray(want))


def test_pack_hop_rows_np_jnp_agree(pcm16):
    flat = pcm16.astype(np.float32)
    rn = pack_hop_rows(flat, n_fft=512, hop=80)
    rj = pack_hop_rows(jnp.asarray(flat), n_fft=512, hop=80)
    assert isinstance(rn, np.ndarray)
    assert np.array_equal(rn, np.asarray(rj))
    # dtype-preserving for int16
    assert pack_hop_rows(pcm16, n_fft=512, hop=80).dtype == np.int16


def test_rows_input_validation(pcm16):
    rows, _ = _rows_and_flat(pcm16)
    with pytest.raises(ValueError, match="n_samples"):
        mfcc_trajectories(rows, CFG16, spectrum="matmul")
    with pytest.raises(ValueError, match="pack_hop_rows"):
        mfcc_trajectories(rows[:, :-16], CFG16, spectrum="matmul",
                          n_samples=pcm16.shape[-1])


def test_bf16_split_is_exact_rounding():
    """The x3 operand split: hi is x rounded to bf16 (nearest even, as the
    f32→bf16 cast), lo the bf16 of the remainder, |x − hi − lo| ≤ 2⁻¹⁶|x| —
    computed on bit patterns so no compiler may fold the split away."""
    from modulation_mfcc.ops.spectral import _split_bf16

    rng = np.random.default_rng(5)
    x = (rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32)
    hi, lo = (np.asarray(v, np.float64) for v in _split_bf16(jnp.asarray(x)))
    np.testing.assert_array_equal(hi, np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float64))
    x64 = x.astype(np.float64)
    assert np.all(np.abs(x64 - hi - lo) <= 2.0**-16 * np.abs(x64))
    assert np.any(lo != 0.0)
