"""Golden parity: JAX MFCC + modulation pipeline vs the float64 CPU oracle
(modulation_mfcc/oracle.py replicating librosa semantics, scipy filters)."""
import numpy as np
import pytest

import jax.numpy as jnp

from modulation_mfcc import MfccConfig, extract_mfcc_change
from modulation_mfcc.models.modulation import mfcc_trajectories, modulation_spectrum
from modulation_mfcc.oracle import get_mfccs_change_np, mfcc_np


def test_mfcc_matrix_parity(speechlike):
    y, sr = speechlike
    cfg = MfccConfig()
    got = np.asarray(mfcc_trajectories(jnp.asarray(y), cfg))  # [N, n_mfcc]
    want = mfcc_np(
        y, sr, n_mfcc=13, win_length=cfg.win_length, hop_length=cfg.hop_length,
        n_fft=512, fmin=100.0, fmax=10000.0,
    ).T
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_mfcc_change_parity(speechlike):
    y, sr = speechlike
    tot, t = extract_mfcc_change(y)
    want, t_want = get_mfccs_change_np(y, sr)
    assert tot.shape == want.shape
    np.testing.assert_allclose(np.asarray(t), t_want, atol=1e-9)
    np.testing.assert_allclose(np.asarray(tot), want, atol=1e-4, rtol=0)


def test_mfcc_change_matmul_path_matches_fft_path(speechlike):
    y, _ = speechlike
    a, _ = extract_mfcc_change(y, use_fft=True)
    b, _ = extract_mfcc_change(y, use_fft=False)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-4, rtol=0)


def test_mfcc_change_batched_matches_single(speechlike, rng):
    y, sr = speechlike
    batch = np.stack([y, np.roll(y, 1234), 0.5 * y])
    cfg = MfccConfig()
    tot_b, _ = extract_mfcc_change(batch, cfg)
    for i in range(3):
        tot_s, _ = extract_mfcc_change(batch[i], cfg)
        np.testing.assert_allclose(np.asarray(tot_b[i]), np.asarray(tot_s), atol=1e-5, rtol=0)


def test_custom_config_out_filter_none(speechlike):
    y, sr = speechlike
    cfg = MfccConfig(outFilter=None)
    tot, _ = extract_mfcc_change(y, cfg)
    want, _ = get_mfccs_change_np(y, sr, out_filter=None)
    np.testing.assert_allclose(np.asarray(tot), want, atol=1e-4, rtol=0)


def test_custom_config_sg_diff(speechlike):
    y, sr = speechlike
    cfg = MfccConfig(diffMethod="sg")
    tot, _ = extract_mfcc_change(y, cfg)
    want, _ = get_mfccs_change_np(y, sr, diff_method="sg")
    np.testing.assert_allclose(np.asarray(tot), want, atol=1e-4, rtol=0)


def test_modulation_spectrum_shape(speechlike):
    y, _ = speechlike
    cfg = MfccConfig()
    spec = modulation_spectrum(jnp.asarray(y), cfg, mod_n_fft=128, mod_hop=16)
    assert spec.shape[0] == 12  # n_coef after removeFirst
    assert spec.shape[-1] == 65  # 128//2+1
    assert np.all(np.isfinite(np.asarray(spec)))


def test_config_json_roundtrip():
    from modulation_mfcc import PipelineConfig, config_from_reference_json, config_to_reference_json

    cfg = PipelineConfig()
    d = config_to_reference_json(cfg)
    assert d["mfcc"]["tStep"] == 0.005
    assert d["f0"]["method"] == "praatac"
    cfg2 = config_from_reference_json(d)
    assert cfg2.mfcc == cfg.mfcc
    assert cfg2.f0 == cfg.f0
    # reference-style extra keys (enabled/name/panel) are tolerated
    d["mfcc"]["enabled"] = True
    d["mfcc"]["name"] = "custom"
    d["mfcc"]["panel"] = 2
    cfg3 = config_from_reference_json(d)
    assert cfg3.mfcc == cfg.mfcc

