"""I/O round-trips: WAV, AG50x EMA, TextGrid, CSV export."""
import csv

import numpy as np
import pytest

from modulation_mfcc.io.ag50x import DIMS, linear_resample, read_ag50x, write_ag50x
from modulation_mfcc.io.csvexport import CurveColumn, export_curves_csv, interval_aggregations
from modulation_mfcc.io.textgrid import (
    Interval,
    IntervalTier,
    Point,
    PointTier,
    TextGrid,
    read_textgrid,
    write_textgrid,
)
from modulation_mfcc.io.wav import read_wav, resample, write_wav


def test_wav_roundtrip_int16(tmp_path, rng):
    sr = 16_000
    y = np.clip(rng.standard_normal(sr) * 0.3, -1, 1)
    p = str(tmp_path / "a.wav")
    write_wav(p, y, sr)
    x, sr2 = read_wav(p)
    assert sr2 == sr
    np.testing.assert_allclose(x, y, atol=2.0 / 32768)  # 1 LSB quant + scale


def test_wav_multichannel(tmp_path, rng):
    sr = 8000
    y = np.stack([np.sin(np.linspace(0, 50, sr)), np.cos(np.linspace(0, 50, sr))])
    p = str(tmp_path / "st.wav")
    write_wav(p, y, sr)
    x, _ = read_wav(p)
    assert x.shape == y.shape
    np.testing.assert_allclose(x, y, atol=1e-3)


def test_wav_extensible_float32(tmp_path, rng):
    """WAVE_FORMAT_EXTENSIBLE (0xFFFE) must read the SubFormat GUID — an
    extensible float32 file previously decoded as int32 garbage."""
    import struct

    sr = 8000
    y = (0.5 * rng.standard_normal(1000)).astype(np.float32)
    subformat_float = struct.pack("<H", 3) + b"\x00\x00" + b"\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    fmt = struct.pack(
        "<HHIIHH", 0xFFFE, 1, sr, sr * 4, 4, 32
    ) + struct.pack("<HHI", 22, 32, 0x4) + subformat_float
    data = y.tobytes()
    body = (
        b"fmt " + struct.pack("<I", len(fmt)) + fmt
        + b"data" + struct.pack("<I", len(data)) + data
    )
    p = tmp_path / "ext.wav"
    p.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)
    x, sr2 = read_wav(str(p))
    assert sr2 == sr
    np.testing.assert_allclose(x, y, atol=1e-7)


def test_resample_preserves_tone(rng):
    sr, target = 44_100, 10_000
    t = np.arange(sr) / sr
    y = np.sin(2 * np.pi * 440 * t)
    z = resample(y, sr, target)
    assert abs(len(z) - target) <= 2
    # dominant frequency preserved
    spec = np.abs(np.fft.rfft(z * np.hanning(len(z))))
    peak = np.argmax(spec) * target / len(z)
    assert abs(peak - 440) < 2


def test_resampler_feature_divergence(rng):
    """Bound the 44.1 kHz→10 kHz resampler's end-to-end MFCC divergence
    against the ideal band-limited oracle (VERDICT round-1 item 6).

    For a signal that is band-limited below the target passband and zero at
    its edges, periodic (Fourier) resampling IS the ideal band-limited
    result, and every high-quality resampler (librosa's soxr_hq /
    kaiser_best included) agrees with it to its ripple spec — so this bound
    also bounds the divergence from the reference's librosa.load convention.
    """
    from scipy.signal import resample as fourier_resample

    from modulation_mfcc.oracle import get_mfccs_change_np

    sr_in, sr_out = 44_100, 10_000
    n = sr_in  # 1 s → integer-Hz bins are exactly periodic
    t = np.arange(n) / sr_in
    y = sum(
        a * np.sin(2 * np.pi * f * t)
        for f, a in [(220, 0.5), (880, 0.3), (1760, 0.2), (3520, 0.1)]
    )
    # fade edges to zero so periodic and zero extensions coincide
    fade = int(0.1 * sr_in)
    env = np.ones(n)
    env[:fade] = 0.5 - 0.5 * np.cos(np.pi * np.arange(fade) / fade)
    env[-fade:] = env[:fade][::-1]
    y = y * env
    ideal = fourier_resample(y, sr_out)
    ours = resample(y, sr_in, sr_out)
    assert len(ours) == len(ideal)
    got, _ = get_mfccs_change_np(ours, float(sr_out))
    want, _ = get_mfccs_change_np(ideal, float(sr_out))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_resampler_passband_flatness():
    """kaiser_best-grade spec: a passband tone's amplitude is preserved to
    ~1e-4 through the 44.1k→10k polyphase."""
    sr_in, sr_out = 44_100, 10_000
    t = np.arange(2 * sr_in) / sr_in
    y = np.sin(2 * np.pi * 1000 * t)
    z = resample(y, sr_in, sr_out)
    mid = z[len(z) // 4 : -len(z) // 4]
    mid = mid[: (len(mid) // 10) * 10]  # whole cycles of the 1 kHz tone
    amp = np.sqrt(2.0) * np.sqrt(np.mean(mid**2))
    assert abs(amp - 1.0) < 2e-4


def test_linear_resample_matches_interp(rng):
    import jax.numpy as jnp

    src_t = np.linspace(0, 1, 100)
    vals = rng.standard_normal((100, 4, 7))
    dst_t = np.arange(0, 1.2, 0.013)  # includes extrapolation region
    got = np.asarray(linear_resample(jnp.asarray(vals), jnp.asarray(src_t), jnp.asarray(dst_t)))
    from scipy.interpolate import interp1d

    for i in range(4):
        for j in range(7):
            f = interp1d(src_t, vals[:, i, j], kind="linear", fill_value="extrapolate")
            np.testing.assert_allclose(got[:, i, j], f(dst_t), atol=1e-9)


def test_ag50x_roundtrip(tmp_path, rng):
    t, ch = 500, 8
    pos = rng.standard_normal((t, ch, 7)).astype(np.float32)
    p = str(tmp_path / "rec.pos")
    write_ag50x(p, pos, sample_rate=250)
    ema = read_ag50x(p, target_sample_rate=200)
    assert ema.original_samplerate == 250
    assert ema.resampled_samplerate == 200
    assert ema.ema.shape[1:] == (ch, 7)
    assert ema.dimensions == DIMS
    # resampled values stay within the original range per channel
    tt, z = ema.channel(3, "z")
    assert tt.shape == z.shape
    assert z.min() >= pos[:, 3, 1].min() - 1e-3
    assert z.max() <= pos[:, 3, 1].max() + 1e-3


def _sample_tg():
    tg = TextGrid(xmin=0, xmax=2)
    it = IntervalTier(name="words", xmin=0, xmax=2)
    it.add(0.0, 0.5, "hello")
    it.add(0.5, 1.2, "world")
    it.add(1.2, 2.0, "")
    pt = PointTier(name="peaks", xmin=0, xmax=2)
    pt.add(0.25, "p1")
    pt.add(0.75, "p2")
    tg.tiers = [it, pt]
    return tg


def test_textgrid_roundtrip(tmp_path):
    tg = _sample_tg()
    p = str(tmp_path / "a.TextGrid")
    write_textgrid(tg, p)
    tg2 = read_textgrid(p)
    assert tg2.tier_names() == ["words", "peaks"]
    it = tg2.get_tier("words")
    assert [iv.text for iv in it.intervals] == ["hello", "world", ""]
    assert it.label_at(0.7) == "world"
    pt = tg2.get_tier("peaks")
    assert [p_.time for p_ in pt.points] == [0.25, 0.75]


def test_textgrid_short_format(tmp_path):
    short = (
        'File type = "ooTextFile"\n'
        'Object class = "TextGrid"\n\n'
        "0\n2\n<exists>\n1\n"
        '"IntervalTier"\n"words"\n0\n2\n2\n'
        '0\n1\n"ab"\n1\n2\n"cd"\n'
    )
    p = tmp_path / "s.TextGrid"
    p.write_text(short)
    tg = read_textgrid(str(p))
    it = tg.get_tier("words")
    assert [iv.text for iv in it.intervals] == ["ab", "cd"]


def test_interval_overlap_validation():
    it = IntervalTier(name="x")
    it.add(0.0, 1.0, "a")
    with pytest.raises(ValueError, match="overlaps"):
        it.add(0.5, 1.5, "b")
    it.add(1.0, 2.0, "c")  # touching is fine


def test_labels_at_vectorized():
    tg = _sample_tg()
    it = tg.get_tier("words")
    labels = it.labels_at(np.array([0.1, 0.5, 0.9, 1.5, 3.0]))
    assert labels == ["hello", "hello", "world", "", ""]


def test_csv_export_full(tmp_path):
    tg = _sample_tg()
    t = np.linspace(0, 2, 21)
    c = CurveColumn(
        name="mod",
        times=t,
        values=np.sin(t),
        max_times=np.array([0.5]),
        max_values=np.array([0.9]),
        include_max=True,
    )
    p = str(tmp_path / "out.csv")
    export_curves_csv(
        p, [c], textgrid=tg, tier_names=["words"], region=(0.0, 1.0), aggregate_tier="words"
    )
    with open(p) as f:
        rows = list(csv.reader(f))
    hdr = rows[0]
    assert "mod_x" in hdr and "mod_words" in hdr and "mod_max_x" in hdr
    assert "region_duration" in hdr and "mod_interval_mean" in hdr
    words_col = hdr.index("mod_words")
    assert rows[1][words_col] == "hello"
    aggs = interval_aggregations([c], tg.get_tier("words"))
    assert [a[0] for a in aggs] == ["hello", "world"]
    assert abs(aggs[0][3] - 0.5) < 1e-9


def test_interval_delete_merges_labels():
    """Deleting a boundary merges neighbors and concatenates names
    (reference praat_py_ui/markers.py:131-146)."""
    it = IntervalTier(name="w", xmax=3.0)
    it.add(0.0, 1.0, "ba")
    it.add(1.0, 2.0, "na")
    it.add(2.0, 3.0, "nas")
    merged = it.delete_boundary(0)
    assert merged.start == 0.0 and merged.end == 2.0
    assert merged.text == "bana"
    assert len(it.intervals) == 2
    it.delete_boundary(0)
    assert it.intervals[0].text == "bananas"
    with pytest.raises(IndexError):
        it.delete_boundary(0)  # single interval left: no inner boundary


def test_tier_boundary_editing():
    """Programmatic tier editing: boundary move with min-duration clamping
    + relabel (the reference's editable tier widgets, praat_py_ui/tiers.py)."""
    it = IntervalTier(name="w", xmax=2.0)
    it.add(0.0, 0.5, "a")
    it.add(0.5, 1.0, "b")
    it.add(1.0, 2.0, "c")
    # normal move
    t = it.move_boundary(0, 0.7)
    assert t == 0.7 and it.intervals[0].end == 0.7 and it.intervals[1].start == 0.7
    # clamped: can't shrink 'b' below min duration
    t = it.move_boundary(0, 0.999)
    assert t == pytest.approx(1.0 - it.MIN_DURATION)
    with pytest.raises(IndexError):
        it.move_boundary(2, 1.5)
    it.relabel(1, "B")
    assert it.intervals[1].text == "B"
    # point move keeps order
    pt = PointTier(name="p")
    pt.add(0.3, "x")
    pt.add(0.6, "y")
    pt.move(0.3, 0.9)
    assert [round(p.time, 4) for p in pt.points] == [0.6, 0.9]
