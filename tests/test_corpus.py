"""Corpus sweep: batching, per-file isolation, resume, output records."""
import os

import numpy as np

from modulation_mfcc.io.wav import write_wav
from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.parallel.corpus import CorpusSweep, sweep_mfcc_change
from modulation_mfcc.oracle import get_mfccs_change_np


def _mk_corpus(d, n=5, sr=10_000):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        dur = 0.8 + 0.2 * (i % 3)
        t = np.arange(int(dur * sr)) / sr
        y = 0.6 * np.sin(2 * np.pi * (120 + 10 * i) * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
        y += 0.01 * rng.standard_normal(len(t))
        p = str(d / f"utt{i}.wav")
        write_wav(p, y, sr)
        paths.append(p)
    return paths


def test_sweep_end_to_end(tmp_path):
    paths = _mk_corpus(tmp_path / "wavs" if (tmp_path / "wavs").mkdir() or True else None, n=5)
    out = tmp_path / "feats"
    sweep = CorpusSweep(out_dir=str(out), batch_size=3, spectrum="fft")
    report = sweep_mfcc_change(paths, sweep)
    assert report["items"] == 5
    assert report["audio_hours_per_sec"] > 0
    # every file has a record with parity-grade values
    for p in paths:
        rec = np.load(out / (os.path.splitext(os.path.basename(p))[0] + ".npz"))
        assert rec["times"].shape == rec["mod_cepstr"].shape
    # spot-check one file vs the oracle
    from modulation_mfcc.io.wav import load_channel

    y = load_channel(paths[0], 10_000)
    want, _ = get_mfccs_change_np(np.asarray(y, dtype=np.float64), 10_000)
    rec = np.load(out / "utt0.npz")
    np.testing.assert_allclose(rec["mod_cepstr"], want, atol=1e-4)


def test_sweep_multifeature_and_mesh(tmp_path):
    """Sweep with f0+envelope extras, sharded over the virtual 8-device mesh."""
    from modulation_mfcc.parallel.mesh import make_mesh

    paths = _mk_corpus(tmp_path, n=4)
    out = tmp_path / "feats"
    sweep = CorpusSweep(
        out_dir=str(out), batch_size=4, spectrum="fft",
        features=("mod_cepstr", "f0", "envelope", "mfcc39", "formants"),
        mesh=make_mesh(8, 1),
    )
    report = sweep_mfcc_change(paths, sweep)
    assert report["items"] == 4
    rec = np.load(out / "utt1.npz")
    assert {"times", "mod_cepstr", "f0", "f0_times", "envelope", "envelope_times",
            "mfcc39", "formants", "formant_bw"} <= set(rec.keys())
    assert rec["mfcc39"].ndim == 2 and rec["mfcc39"].shape[1] == 39
    v = rec["f0"][rec["f0"] > 0]
    assert abs(np.median(v) - 130.0) < 5.0  # utt1: 120+10*1 Hz tone
    assert rec["envelope"].max() > 0.1


def test_sweep_basename_collision(tmp_path):
    """Same filename in two directories must produce two distinct records —
    basename keying used to silently overwrite one of them."""
    sr = 10_000
    paths = []
    for sub, freq in (("a", 150.0), ("b", 400.0)):
        d = tmp_path / sub
        d.mkdir()
        t = np.arange(sr) / sr
        p = str(d / "utt.wav")
        write_wav(p, 0.6 * np.sin(2 * np.pi * freq * t), sr)
        paths.append(p)
    out = tmp_path / "feats"
    sweep = CorpusSweep(out_dir=str(out), batch_size=2, spectrum="fft")
    report = sweep_mfcc_change(paths, sweep)
    assert report["items"] == 2
    recs = [f for f in os.listdir(out) if f.endswith(".npz")]
    assert len(recs) == 2, recs


def test_sweep_resume_and_isolation(tmp_path):
    paths = _mk_corpus(tmp_path, n=4)
    # corrupt file must be skipped, not abort
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav at all")
    out = tmp_path / "feats"
    sweep = CorpusSweep(out_dir=str(out), batch_size=2, spectrum="fft")
    r1 = sweep_mfcc_change(paths[:2] + [bad], sweep)
    assert r1["items"] == 2  # bad skipped
    # resume: already-done files are not recomputed
    r2 = sweep_mfcc_change(paths[:2] + [bad] + paths[2:], sweep)
    assert r2["items"] == 2  # only the two new ones
    done = (out / "_done.txt").read_text().splitlines()
    assert len(done) == 4


def test_cli_sweep_features_flag(tmp_path):
    """`cli sweep --features` plumbs the comma list into CorpusSweep."""
    from modulation_mfcc.cli import main as cli_main

    paths = _mk_corpus(tmp_path, n=2)
    out = tmp_path / "feats"
    rc = cli_main([
        "sweep", *paths, "--out", str(out), "--spectrum", "fft",
        "--features", "mod_cepstr,f0", "--batch-size", "2",
    ])
    assert rc in (0, None)
    rec = np.load(out / "utt0.npz")
    assert {"mod_cepstr", "f0", "f0_times"} <= set(rec.keys())
    assert "envelope" not in rec


def test_sweep_formants_feature(tmp_path):
    """'formants' sweeps through the device-side 2x-ceiling resample."""
    paths = _mk_corpus(tmp_path, n=2, sr=10_000)
    out = tmp_path / "feats"
    sweep = CorpusSweep(
        out_dir=str(out), batch_size=2, spectrum="fft",
        features=("mod_cepstr", "formants"),
    )
    report = sweep_mfcc_change(paths, sweep)
    assert report["items"] == 2
    rec = np.load(out / "utt0.npz")
    assert {"formants", "formant_bw", "formants_times"} <= set(rec.keys())
    fr = rec["formants"]
    assert fr.ndim == 2 and fr.shape[1] == 5
    # some frames track at least one in-band formant
    assert np.isfinite(fr).any()


def test_int16_upload_path_exact(tmp_path):
    """16-bit-grid buckets ship as int16 and dequantize bit-identically;
    off-grid (e.g. resampled) buckets keep float32."""
    import jax.numpy as jnp

    from modulation_mfcc.parallel.batch import dequantize_samples
    from modulation_mfcc.parallel.corpus import _make_batch

    rng = np.random.default_rng(3)
    on_grid = (rng.integers(-(2**15), 2**15 - 1, 4000).astype(np.float32)) / 32768.0
    _, arrays, _ = _make_batch([("a.wav", on_grid)], 4096)
    assert arrays["samples"].dtype == np.int16
    deq = np.asarray(dequantize_samples(jnp.asarray(arrays["samples"])))
    np.testing.assert_array_equal(deq[0, :4000], on_grid)
    # edge value -1.0 (= -32768) is on-grid
    _, arrays, _ = _make_batch([("b.wav", np.full(100, -1.0, np.float32))], 128)
    assert arrays["samples"].dtype == np.int16
    # off-grid floats must NOT quantize
    off = on_grid + 1e-6
    _, arrays, _ = _make_batch([("c.wav", off.astype(np.float32))], 4096)
    assert arrays["samples"].dtype == np.float32
    # out-of-range (>1) floats must NOT quantize (cast wraps, compare catches)
    loud = np.full(100, 1.5, np.float32)
    _, arrays, _ = _make_batch([("d.wav", loud)], 128)
    assert arrays["samples"].dtype == np.float32


def test_sweep_hop_rows_path_matches_flat(tmp_path):
    """The hop-rows corpus path (matmul spectrum + mod_cepstr-only + int16
    buckets): records must equal the flat int16-upload sweep's bitwise —
    the rows contract dequantizes on device with an exact ·2⁻¹⁵ and only
    reshapes the pre-padded buffer. Runs the real sweep driver twice."""
    sr = 16_000
    rng = np.random.default_rng(11)
    paths = []
    for i in range(3):
        n = int(sr * (0.5 + 0.1 * i))
        y = (rng.integers(-8000, 8000, n).astype(np.float32)) / 32768.0
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, y, sr)
        paths.append(p)
    cfg = MfccConfig(signal_sample_rate=sr, maxFreq=8000.0)
    sweep_rows = CorpusSweep(
        out_dir=str(tmp_path / "rows"), cfg=cfg, batch_size=3,
        spectrum="matmul_i16", resume=False,
    )
    rep = sweep_mfcc_change(paths, sweep_rows)
    assert rep["items"] == 3
    # flat comparison: force the non-rows assembly by requesting a second
    # (flat-consuming) feature alongside — envelope uses flat samples, so
    # rows_mode must disable itself
    from modulation_mfcc.models.config import AmplitudeConfig

    sweep_flat = CorpusSweep(
        out_dir=str(tmp_path / "flat"), cfg=cfg, batch_size=3,
        spectrum="matmul_i16", resume=False,
        features=("mod_cepstr", "envelope"),
        amp_cfg=AmplitudeConfig(method="RMS"),
    )
    sweep_mfcc_change(paths, sweep_flat)
    for i in range(3):
        r = np.load(tmp_path / "rows" / f"u{i}.npz")
        f = np.load(tmp_path / "flat" / f"u{i}.npz")
        np.testing.assert_array_equal(r["mod_cepstr"], f["mod_cepstr"])
        np.testing.assert_array_equal(r["times"], f["times"])
