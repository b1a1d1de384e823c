"""Infrastructure units: prefetch, observability, config file round-trip,
modulation-spectrum axes, CLI smoke."""
import json
import subprocess
import sys
import time

import numpy as np
import pytest

import jax.numpy as jnp

from modulation_mfcc.models.config import F0Config, PipelineConfig, load_config, save_config
from modulation_mfcc.models.modulation import modulation_spectrum, modulation_spectrum_axes
from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.parallel.prefetch import background_iter, prefetch_to_device
from modulation_mfcc.utils.obs import ThroughputMeter, log_event, profile_trace


def test_background_iter_order_and_errors():
    out = list(background_iter(iter(range(10)), maxsize=3))
    assert out == list(range(10))

    def gen():
        yield 1
        raise ValueError("boom")

    it = background_iter(gen(), maxsize=2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_prefetch_to_device_yields_all():
    batches = [{"a": np.full((4,), i, np.float32)} for i in range(5)]
    got = list(prefetch_to_device(iter(batches), depth=2))
    assert len(got) == 5
    for i, b in enumerate(got):
        np.testing.assert_array_equal(np.asarray(b["a"]), batches[i]["a"])


def test_throughput_meter():
    m = ThroughputMeter()
    m.add(3600.0, items=4)
    time.sleep(0.01)
    rep = m.report()
    assert rep["items"] == 4
    assert rep["audio_hours"] == 1.0
    assert rep["audio_hours_per_sec"] > 0


def test_profile_trace_noop():
    with profile_trace(None):
        pass  # must be transparent when disabled


def test_config_file_roundtrip(tmp_path):
    cfg = PipelineConfig(f0=F0Config(minPitch=60.0, method="praatcc"))
    p = str(tmp_path / "analysis.json")
    save_config(cfg, p)
    loaded = load_config(p)
    assert loaded.f0.minPitch == 60.0
    assert loaded.f0.method == "praatcc"
    # the file is the reference dialog's schema
    raw = json.load(open(p))
    assert set(raw) == {"mfcc", "amplitude", "formant1", "formant2", "formant3", "f0", "ema"}
    assert raw["mfcc"]["tStep"] == 0.005


def test_modulation_spectrum_axes(speechlike):
    y, sr = speechlike
    cfg = MfccConfig()
    spec = modulation_spectrum(jnp.asarray(y, dtype=jnp.float32), cfg)
    freqs, times = modulation_spectrum_axes(len(y), cfg)
    assert spec.shape[-1] == len(freqs)
    assert spec.shape[-2] == len(times)
    assert freqs[-1] == 100.0  # Nyquist of the 200 Hz trajectory rate


def test_cli_verify_harness():
    """The full tracker parity harness (mod_cepstr + intensity + pitch ac +
    pyin vs their float64 oracles) must pass end-to-end on the CPU backend —
    this is the exact command run on the card (`modmfcc verify`)."""
    out = subprocess.run(
        [sys.executable, "-m", "modulation_mfcc.cli", "verify",
         "--seconds", "1.2"],
        capture_output=True, text=True, timeout=540,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": ".", "HOME": "/root"},
        cwd="/root/repo",
    )
    assert out.returncode == 0, out.stdout[-800:] + out.stderr[-500:]
    lines = [json.loads(l) for l in out.stdout.strip().splitlines() if l.startswith("{")]
    assert lines[-1] == {"overall_pass": True}
    surfaces = {l["surface"] for l in lines[:-1]}
    # The harness may grow surfaces over time; assert the core set is a
    # subset so this test doesn't rot the way the 4-surface assert did.
    assert surfaces >= {
        "mod_cepstr", "intensity", "pitch_ac", "pyin",
        "formants", "envelope_rms", "envelope_hilbert",
    }, surfaces


def test_cli_info_smoke():
    out = subprocess.run(
        [sys.executable, "-m", "modulation_mfcc.cli", "info"],
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": ".", "HOME": "/root"},
        cwd="/root/repo",
    )
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["backend"] == "cpu"
