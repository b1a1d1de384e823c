"""pYIN validation: CMNDF correctness vs direct numpy + tracking accuracy."""
import pytest
import numpy as np

import jax.numpy as jnp

from modulation_mfcc.models.config import F0Config
from modulation_mfcc.models.pitch import extract_f0
from modulation_mfcc.ops.yin import pyin_f0, yin_cmndf

SR = 10_000


def test_cmndf_matches_direct(rng):
    # librosa's difference function quirks, written out directly: the
    # correlation sums j = 0..w INCLUSIVE, the energies sum
    # j = tau+1..tau+w, small values snap to zero.
    n, max_lag = 512, 200
    w = n - max_lag - 1
    x = rng.standard_normal(n)
    c = np.zeros(max_lag + 1)
    e = np.zeros(max_lag + 1)
    for tau in range(max_lag + 1):
        c[tau] = np.sum(x[: w + 1] * x[tau : tau + w + 1])
        e[tau] = np.sum(x[tau + 1 : tau + w + 1] ** 2)
    c[np.abs(c) < 1e-6] = 0.0
    e[np.abs(e) < 1e-6] = 0.0
    d = e[0] + e - 2 * c
    cm = np.ones(max_lag + 1)
    for tau in range(1, max_lag + 1):
        cm[tau] = d[tau] / (np.mean(d[1 : tau + 1]) + np.finfo(np.float64).tiny)
    got = np.asarray(yin_cmndf(jnp.asarray(x[None, :]), max_lag))[0]
    np.testing.assert_allclose(got, cm, rtol=1e-6, atol=1e-8)


def _harmonic(f0, dur=1.0, sr=SR):
    t = np.arange(int(dur * sr)) / sr
    return sum((0.7 / k) * np.sin(2 * np.pi * k * f0 * t) for k in range(1, 5))


def test_pyin_constant_tone():
    y = _harmonic(220.0)
    f0 = np.asarray(pyin_f0(jnp.asarray(y, dtype=jnp.float32), sr=SR))
    v = f0[f0 > 0]
    assert len(v) > 0.8 * len(f0)
    assert abs(np.median(v) - 220.0) < 220.0 * 0.006  # within the 0.1-semitone grid


def test_pyin_detects_unvoiced(rng):
    y = np.concatenate([0.01 * rng.standard_normal(SR // 2), _harmonic(150.0, 0.5)])
    f0 = np.asarray(pyin_f0(jnp.asarray(y, dtype=jnp.float32), sr=SR))
    n = len(f0)
    assert (f0[: n // 3] == 0).mean() > 0.6
    mid = f0[-n // 3 :]
    assert (mid > 0).mean() > 0.8
    assert abs(np.median(mid[mid > 0]) - 150.0) < 2.0


def test_extract_f0_pyin_method():
    y = _harmonic(180.0)
    cfg = F0Config(method="pyin", outFilter=None, interpUnvoiced="linear")
    f0, t = extract_f0(y, SR, cfg)
    v = f0[np.isfinite(f0)]
    assert abs(np.median(v) - 180.0) < 2.5
    assert t.shape == f0.shape


def test_sliding_cmndf_matches_framed(rng):
    from modulation_mfcc.ops.framing import frame_by_slices
    from modulation_mfcc.ops.yin import _sliding_cmndf

    for hop, w, ml, n in ((10, 64, 17, 500), (7, 50, 12, 301), (25, 100, 30, 800)):
        x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        nf = 1 + (n - (w + ml + 1)) // hop
        frames = frame_by_slices(x, 0, nf, w + ml + 1, hop)
        want = np.asarray(yin_cmndf(frames, ml, win_length=w))
        got = np.asarray(_sliding_cmndf(x, nf, hop, w, ml))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def _speechlike_sig():
    rng = np.random.default_rng(20260816)
    sr = 10_000
    t = np.arange(int(2.0 * sr)) / sr
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 2.5 * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    sig = sum((0.6 / k) * np.sin(k * phase) for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 4.0 * t - np.pi / 2))
    sig = sig * env + 0.01 * rng.standard_normal(len(t))
    sig[: sr // 10] = 0.0
    sig[-sr // 10 :] = 0.0
    return sig, sr


def test_pyin_matches_float64_oracle():
    """Decoded pitch states must match the librosa-exact float64 oracle
    (oracle.pyin_np) bit-for-bit on the speech-like fixture (VERDICT r2 #2)."""
    from modulation_mfcc.oracle import pyin_np

    sig, sr = _speechlike_sig()
    of0, ovoiced, _ = pyin_np(sig, sr, hop_length=100)
    jf0 = np.asarray(pyin_f0(jnp.asarray(sig), sr=float(sr)))
    jvoiced = jf0 > 0
    assert jf0.shape == of0.shape
    np.testing.assert_array_equal(jvoiced, ovoiced)
    np.testing.assert_allclose(jf0[jvoiced], of0[ovoiced], rtol=1e-12)
    # sanity: the fixture exercises both voicing states
    assert 0.2 < ovoiced.mean() < 0.95


def test_cmndf_matches_oracle_band():
    """Device CMNDF (sliding form) vs the oracle's float64 band <= 1e-6."""
    from modulation_mfcc.ops.yin import _sliding_cmndf

    sig, sr = _speechlike_sig()
    frame_length, w, hop = 2048, 1024, 100
    min_p = max(1, int(np.floor(sr / 600.0)))
    max_p = min(int(np.ceil(sr / 75.0)), frame_length - w - 1)
    xp = np.pad(sig, frame_length // 2)
    nf = 1 + len(sig) // hop
    cm = np.asarray(_sliding_cmndf(jnp.asarray(xp), nf, hop, w, max_p))
    # oracle band via pyin_np internals: recompute directly
    idx = np.arange(nf)[:, None] * hop + np.arange(frame_length)[None, :]
    frames = xp[idx]
    acf = np.empty((nf, max_p + 1))
    for tau in range(max_p + 1):
        acf[:, tau] = np.sum(frames[:, : w + 1] * frames[:, tau : tau + w + 1], axis=1)
    acf[np.abs(acf) < 1e-6] = 0.0
    cs = np.cumsum(frames**2, axis=1)
    energy = (cs[:, w:] - cs[:, :-w])[:, : max_p + 1].copy()
    energy[np.abs(energy) < 1e-6] = 0.0
    d = energy[:, :1] + energy - 2.0 * acf
    cum_mean = np.cumsum(d[:, 1:], axis=1) / np.arange(1, max_p + 1)
    want = d[:, min_p:] / (cum_mean[:, min_p - 1 :] + np.finfo(np.float64).tiny)
    got = cm[:, min_p:]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_pyin_oracle_parity_collision_heavy():
    """44.1 kHz wide-band config where adjacent lags round to ONE pitch bin
    (lags >~346 at 10 bins/semitone): exercises the last-write-wins bin
    projection, for both even and odd frame_length (odd loses one frame of
    span under centered padding). Bit-for-bit vs the float64 oracle."""
    from modulation_mfcc.oracle import pyin_np

    rng = np.random.default_rng(0)
    sr = 44100
    t = np.arange(int(0.5 * sr)) / sr
    x = (
        np.sin(2 * np.pi * 110 * t) * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
        + 0.05 * rng.standard_normal(t.shape)
    )
    for fl in (2048, 2047):
        of0, ovoiced, _ = pyin_np(
            x, sr, fmin=65.0, fmax=2093.0, frame_length=fl,
            hop_length=512, center=True,
        )
        jf0 = np.asarray(
            pyin_f0(
                jnp.asarray(x), sr=float(sr), fmin=65.0, fmax=2093.0,
                frame_length=fl, hop=512 / sr, center=True,
            )
        )
        assert jf0.shape == of0.shape
        jvoiced = jf0 > 0
        np.testing.assert_array_equal(jvoiced, ovoiced)
        np.testing.assert_allclose(jf0[jvoiced], of0[ovoiced], rtol=1e-12)


def test_pyin_oracle_parity_f32():
    """Decoded states vs the float64 oracle with FLOAT32 device input —
    the production dtype (extract_f0 casts to f32; the other oracle tests
    run f64 under the suite's x64 default, where reduction-order effects
    vanish). Two envelope-null frames of this fixture sit close enough to
    the voicing decision boundary that the f32 energy term's reduction
    order decides them: the FFT-roundtrip energy path flipped both in f32
    (while passing every f64 gate); the prefix-sum energy term matches the
    oracle exactly."""
    from modulation_mfcc.oracle import pyin_np

    sig, sr = _speechlike_sig()
    of0, ovoiced, _ = pyin_np(sig, sr, fmin=75.0, fmax=600.0, hop_length=100)
    jf0 = np.asarray(
        pyin_f0(
            jnp.asarray(sig, dtype=jnp.float32), sr=float(sr), fmin=75.0, fmax=600.0
        )
    )
    assert jf0.shape == of0.shape
    jvoiced = jf0 > 0
    np.testing.assert_array_equal(jvoiced, ovoiced)
    np.testing.assert_allclose(jf0[jvoiced], of0[ovoiced], rtol=1e-5)


def test_pyin_oracle_parity_nondefault_knobs():
    """Oracle parity with the pyin distribution knobs moved off their
    defaults (coarser resolution → different n_bins, different Beta prior,
    hotter Boltzmann, stickier switch_prob, fatter no_trough mass, fewer
    thresholds). All are reference-exposed (script/calc.py:408-419);
    decoded states must stay bit-identical to the float64 oracle."""
    from modulation_mfcc.oracle import pyin_np

    sig, sr = _speechlike_sig()
    kw = dict(
        fmin=65.0, fmax=500.0, n_thresholds=50, beta_parameters=(1.5, 10.0),
        boltzmann_parameter=4, resolution=0.2, max_transition_rate=20.0,
        switch_prob=0.05, no_trough_prob=0.05,
    )
    of0, ovoiced, _ = pyin_np(sig, sr, hop_length=100, **kw)
    jf0 = np.asarray(pyin_f0(jnp.asarray(sig), sr=float(sr), **kw))
    assert jf0.shape == of0.shape
    jvoiced = jf0 > 0
    np.testing.assert_array_equal(jvoiced, ovoiced)
    np.testing.assert_allclose(jf0[jvoiced], of0[ovoiced], rtol=1e-12)


def test_transition_width_guard():
    """width < 1 gives an empty triangular window (librosa raises
    ParameterError); both the device helper and the oracle must refuse
    rather than emit 0/0-NaN rows."""
    import pytest

    from modulation_mfcc.oracle import transition_local_np
    from modulation_mfcc.ops.yin import _transition_local

    for fn in (_transition_local, transition_local_np):
        with pytest.raises(ValueError, match="width"):
            fn(10, 0.5)
    # width exactly 1: a self-loop-only chain, rows sum to 1
    t = _transition_local(10, 1.0)
    np.testing.assert_allclose(t, np.eye(10))


def test_pyin_oracle_parity_uncentered_and_reflect():
    """center=False and pad_mode='reflect' flow through to librosa's
    framing (the reference passes pyincenter/pyinpad_mode verbatim,
    script/calc.py:418-419) — decoded states must still match the float64
    oracle bit-for-bit."""
    from modulation_mfcc.oracle import pyin_np

    sig, sr = _speechlike_sig()
    for kw in ({"center": False}, {"center": True, "pad_mode": "reflect"}):
        of0, ovoiced, _ = pyin_np(sig, sr, hop_length=100, **kw)
        jf0 = np.asarray(pyin_f0(jnp.asarray(sig), sr=float(sr), **kw))
        assert jf0.shape == of0.shape
        jvoiced = jf0 > 0
        np.testing.assert_array_equal(jvoiced, ovoiced)
        np.testing.assert_allclose(jf0[jvoiced], of0[ovoiced], rtol=1e-12)


def test_engine_auto_defaults_resolve_conservative_on_cpu():
    """'auto' engines must be EXACTLY the conservative forms the float64
    oracles pin: pyin auto == fft CMNDF and pitch_ac auto == fft
    autocorrelation, bit-identical (the matmul forms stay selectable)."""
    from modulation_mfcc.ops.pitch import pitch_ac

    sig, sr = _speechlike_sig()
    xj = jnp.asarray(sig, dtype=jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(pyin_f0(xj, sr=float(sr))),
        np.asarray(pyin_f0(xj, sr=float(sr), cmndf_engine="fft")),
    )
    np.testing.assert_array_equal(
        np.asarray(pitch_ac(xj, sr=float(sr))),
        np.asarray(pitch_ac(xj, sr=float(sr), ac_engine="fft")),
    )


def test_engine_names_validated():
    """Typo'd engine values must error, not silently run the default
    engine."""
    from modulation_mfcc.ops.pitch import pitch_ac

    sig, sr = _speechlike_sig()
    xj = jnp.asarray(sig[:4096], dtype=jnp.float32)
    with pytest.raises(ValueError, match="cmndf_engine"):
        pyin_f0(xj, sr=float(sr), cmndf_engine="mxu")
    with pytest.raises(ValueError, match="ac_engine"):
        pitch_ac(xj, sr=float(sr), ac_engine="dft")
    with pytest.raises(TypeError):
        pyin_f0(xj, sr=float(sr), viterbi_engine="xla")
    with pytest.raises(TypeError):
        pitch_ac(xj, sr=float(sr), sinc_engine="xla")


def test_sliding_cmndf_mxu_engine_matches_fft(rng):
    """The real-DFT-matmul CMNDF engine equals the FFT engine up to
    float reduction order (same check grid as the framed-equality test,
    plus a pyin-default-shaped case)."""
    from modulation_mfcc.ops.yin import _sliding_cmndf

    for hop, w, ml, n in (
        (10, 64, 17, 500),
        (7, 50, 12, 301),
        (25, 100, 30, 800),
        (100, 1024, 133, 10_000),  # 10 kHz pyin defaults
    ):
        x = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        nf = 1 + (n - (w + ml + 1)) // hop
        want = np.asarray(_sliding_cmndf(x, nf, hop, w, ml, engine="fft"))
        got = np.asarray(_sliding_cmndf(x, nf, hop, w, ml, engine="matmul"))
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_pyin_cmndf_engine_end_to_end_agreement():
    """pyin_f0 with the matmul CMNDF engine agrees with the FFT default on
    speech-like audio: voicing decisions ≥98% identical, ≤0.5 Hz on
    agreeing voiced frames (reduction-order deltas may flip frames that
    sit exactly on a voicing boundary)."""
    sig, sr = _speechlike_sig()
    xj = jnp.asarray(sig, dtype=jnp.float32)
    fa = np.asarray(pyin_f0(xj, sr=float(sr)))
    fb = np.asarray(pyin_f0(xj, sr=float(sr), cmndf_engine="matmul"))
    agree = (fa > 0) == (fb > 0)
    assert agree.mean() >= 0.98, agree.mean()
    dv = np.abs(np.where(agree & (fa > 0), fa - fb, 0.0))
    assert dv.max() <= 0.5, dv.max()


def test_pyin_states_and_path_score_certificate():
    """return_states exposes the decoded Viterbi path in the oracle's
    state convention, and viterbi_path_score_np scores it: on CPU the
    decode is state-identical to the oracle, so the path-score gap is
    exactly 0 — and any OTHER path must score strictly worse (the
    harness's near-tie certificate separates f32 ties from decode bugs)."""
    from modulation_mfcc import oracle

    sig, sr = _speechlike_sig()
    hop = int(round(0.01 * sr))
    of0, ov, ostates, model = oracle.pyin_np(
        sig.astype(np.float64), sr, hop_length=hop, return_model=True
    )
    jf0, jstates = pyin_f0(
        jnp.asarray(sig, dtype=jnp.float32), sr=float(sr), return_states=True
    )
    jstates = np.asarray(jstates)
    np.testing.assert_array_equal(jstates, ostates)
    # f0 from the states matches the plain return
    np.testing.assert_array_equal(
        np.asarray(jf0), np.asarray(pyin_f0(jnp.asarray(sig, jnp.float32), sr=float(sr)))
    )
    s_o = oracle.viterbi_path_score_np(ostates, model)
    s_d = oracle.viterbi_path_score_np(jstates, model)
    assert s_o == s_d
    # a single-bin perturbation on one voiced frame loses a real margin
    alt = ostates.copy()
    vidx = np.flatnonzero(ov)[len(np.flatnonzero(ov)) // 2]
    alt[vidx] = alt[vidx] + 1
    assert s_o - oracle.viterbi_path_score_np(alt, model) > 0.0


def test_pyin_oracle_bin_shift_invariant_off_boundary():
    """The bin_shift certificate knob (oracle.pyin_np) is a measure-zero
    boundary perturbation: on a signal whose winning troughs sit away from
    .5 bin boundaries the decode is invariant under ±3e-3 — so a
    certificate match is evidence about the boundary, not a loosened
    oracle."""
    from modulation_mfcc import oracle

    sig, sr = _speechlike_sig()
    hop = int(round(0.01 * sr))
    base = oracle.pyin_np(sig.astype(np.float64), sr, hop_length=hop)[2]
    for delta in (-3e-3, 3e-3):
        shifted = oracle.pyin_np(
            sig.astype(np.float64), sr, hop_length=hop, bin_shift=delta
        )[2]
        np.testing.assert_array_equal(shifted, base)
