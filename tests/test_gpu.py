"""Card-only checks: what the CPU suite cannot see (float64 there).

These carry the ``gpu`` marker and skip where JAX has no GPU; on the card
``chip_smoke.py`` runs them (``pytest -m gpu``, float32, x64 off). They pin
the arithmetic the tiers rely on: HIGHEST really is float32 (no TF32), int8
dots accumulate exactly in int32, bf16 dots accumulate in float32 — and the
tiers hold their bars through mfcc_change on the card.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _rel(got, want):
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) / np.max(np.abs(want)))


def test_highest_matmul_is_float32_grade(gpu):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 400)).astype(np.float32)
    b = rng.standard_normal((400, 514)).astype(np.float32)
    got = jnp.matmul(jax.device_put(a, gpu), jax.device_put(b, gpu),
                     precision=jax.lax.Precision.HIGHEST)
    assert _rel(got, a.astype(np.float64) @ b) < 1e-5  # TF32 sits near 1e-3


def test_int8_dot_accumulates_exactly(gpu):
    rng = np.random.default_rng(1)
    a = rng.integers(-128, 128, (512, 800)).astype(np.int8)
    b = rng.integers(-128, 128, (800, 514)).astype(np.int8)
    got = jnp.matmul(jax.device_put(a, gpu), jax.device_put(b, gpu),
                     preferred_element_type=jnp.int32)
    assert got.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(got), a.astype(np.int64) @ b)


def test_bf16_dot_accumulates_in_float32(gpu):
    rng = np.random.default_rng(2)
    a = jnp.asarray(rng.standard_normal((512, 400)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal((400, 514)), jnp.bfloat16)
    got = jnp.matmul(jax.device_put(a, gpu), jax.device_put(b, gpu),
                     preferred_element_type=jnp.float32)
    want = np.asarray(a, np.float64) @ np.asarray(b, np.float64)
    assert got.dtype == jnp.float32
    assert _rel(got, want) < 1e-5


def test_x3_split_survives_the_compiler(gpu):
    """The x3 product must stay three-pass accurate once compiled for the
    card (~2⁻¹⁷ relative), well below one bf16 pass (~2⁻⁹)."""
    from modulation_mfcc.ops.spectral import _x3_dot

    rng = np.random.default_rng(3)
    x = rng.standard_normal((512, 400)).astype(np.float32)
    w = rng.standard_normal((400, 514))
    got = jax.jit(lambda a: _x3_dot(a, w))(jax.device_put(x, gpu))
    assert _rel(got, x.astype(np.float64) @ w) < 1e-4


@pytest.mark.parametrize("spectrum", ["matmul", "matmul_x3", "matmul_bf16",
                                      "matmul_i24", "matmul_i16", "fft"])
def test_tier_parity_on_card(gpu, spectrum):
    from modulation_mfcc.models.config import MfccConfig
    from modulation_mfcc.models.modulation import mfcc_change
    from modulation_mfcc.oracle import get_mfccs_change_np
    from test_tier_parity import TOL, _speech

    sr = 16_000
    cfg = MfccConfig(signal_sample_rate=sr, maxFreq=8000.0)
    pcm = _speech(int(4.0 * sr), 31)
    y = pcm.astype(np.float32) / 32768.0
    want, _ = get_mfccs_change_np(y.astype(np.float64), sr, max_freq=8000.0)
    got = np.asarray(mfcc_change(jax.device_put(jnp.asarray(y)[None], gpu), cfg,
                                 spectrum=spectrum))[0]
    tol = {**TOL, "fft": 1e-4}[spectrum]
    assert np.abs(got - want).max() < tol
