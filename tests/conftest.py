"""Test configuration: run on a virtual 8-device CPU mesh, or on the card.

By default every test runs on the CPU in float64, with 8 virtual host
devices so the multi-device paths (shard_map over a Mesh) are testable
without several cards (SURVEY.md §4). ``MODMFCC_TEST_GPU=1`` (set by
``chip_smoke.py`` for ``pytest -m gpu``) leaves the platform to JAX and
float64 off, so the card-only tests run in float32 on the card. Env vars
must be set before jax initializes its backends, hence the top-of-conftest
placement.
"""
import os

ON_CARD = os.environ.get("MODMFCC_TEST_GPU") == "1"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture()
def gpu():
    """The first GPU device; skips the test where JAX has none (card-only
    tests carry the ``gpu`` marker and run via ``chip_smoke.py``)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.fixture()
def rng():
    # function-scoped: every test sees the same deterministic stream
    # regardless of which other tests ran before it
    return np.random.default_rng(20260816)


@pytest.fixture(scope="session")
def speechlike():
    rng = np.random.default_rng(20260816)
    """A deterministic speech-like test signal: a few seconds at 10 kHz of
    amplitude-modulated harmonics + noise, with silent lead-in/out."""
    sr = 10_000
    t = np.arange(int(2.0 * sr)) / sr
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 2.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    sig = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t - np.pi / 2))
    sig = sig * env + 0.01 * rng.standard_normal(len(t))
    sig[: sr // 10] = 0.0
    sig[-sr // 10 :] = 0.0
    return sig.astype(np.float64), sr
