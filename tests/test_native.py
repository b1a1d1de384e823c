"""Native IO runtime: decode parity vs Python reader, resampler vs scipy,
threaded batch loader end-to-end."""
import numpy as np
import pytest

from modulation_mfcc.io.native import (
    NativeBatchLoader,
    decode_wav_native,
    design_resample_taps,
    native_available,
    resample_native,
)
from modulation_mfcc.io.wav import read_wav, write_wav

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native library unavailable (no toolchain)"
)


def test_decode_matches_python_reader(tmp_path, rng):
    sr = 16_000
    y = np.clip(0.5 * rng.standard_normal(sr), -1, 1)
    p = str(tmp_path / "a.wav")
    write_wav(p, y, sr)
    xn, srn = decode_wav_native(p)
    xp, srp = read_wav(p)
    assert srn == srp == sr
    np.testing.assert_allclose(xn, xp, atol=1e-7)


def test_resample_matches_scipy(rng):
    from scipy.signal import resample_poly

    x = rng.standard_normal(20_000).astype(np.float32)
    up, down = 441, 160  # 16 kHz -> 44.1 kHz
    got = resample_native(x, up, down)
    taps = design_resample_taps(up, down)
    # scipy scales an explicit window by `up` internally, same as the native kernel
    want = resample_poly(x.astype(np.float64), up, down, window=taps)
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_malformed_bits_isolated(tmp_path):
    """A fmt chunk claiming bits=0 must surface as a per-file error, not a
    SIGFPE in the worker thread (division by zero in frame geometry)."""
    import struct

    fmt = struct.pack("<HHIIHH", 1, 1, 8000, 0, 0, 0)  # bits=0
    data = b"\x00" * 64
    body = (
        b"fmt " + struct.pack("<I", len(fmt)) + fmt
        + b"data" + struct.pack("<I", len(data)) + data
    )
    p = tmp_path / "zerobits.wav"
    p.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)

    with pytest.raises(ValueError):
        decode_wav_native(str(p))
    # and through the threaded loader: error isolated, process alive
    loader = NativeBatchLoader(10_000, n_threads=1)
    loader.submit(0, str(p))
    results = dict(iter(loader))
    loader.close()
    assert results[0] is None


def test_batch_loader(tmp_path, rng):
    target = 10_000
    paths = []
    for i, sr in enumerate([10_000, 16_000, 44_100]):
        y = 0.4 * np.sin(2 * np.pi * 220 * np.arange(sr) / sr)
        p = str(tmp_path / f"f{i}.wav")
        write_wav(p, y, sr)
        paths.append(p)
    bad = str(tmp_path / "bad.wav")
    open(bad, "wb").write(b"nope")
    paths.append(bad)

    loader = NativeBatchLoader(target, n_threads=2)
    for i, p in enumerate(paths):
        loader.submit(i, p)
    got = {}
    for idx, samples in loader:
        got[idx] = samples
    loader.close()
    assert set(got) == {0, 1, 2, 3}
    assert got[3] is None  # bad file isolated
    # every valid file ~1 s at the target rate
    for i in range(3):
        assert abs(len(got[i]) - target) < 10
        # still a clean 220 Hz tone after resampling
        spec = np.abs(np.fft.rfft(got[i][:8192] * np.hanning(8192)))
        peak_hz = np.argmax(spec) * target / 8192
        assert abs(peak_hz - 220) < 5
