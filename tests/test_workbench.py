"""AnalysisSession end-to-end: curves, peaks, EMA, TextGrid, CSV, render."""
import csv
import os

import numpy as np
import pytest

from modulation_mfcc.io.ag50x import write_ag50x
from modulation_mfcc.io.textgrid import IntervalTier, TextGrid, write_textgrid
from modulation_mfcc.io.wav import write_wav
from modulation_mfcc.models.workbench import AnalysisSession


@pytest.fixture(scope="module")
def wav_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("wb")
    sr = 10_000
    t = np.arange(int(1.2 * sr)) / sr
    y = 0.7 * np.sin(2 * np.pi * 140 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    p = str(d / "utt.wav")
    write_wav(p, y, sr)
    return p


def test_session_full_workflow(wav_path, tmp_path):
    s = AnalysisSession(wav_path)
    assert s.sound.sample_rate == 10_000
    assert s.spectrogram.data_matrix.ndim == 2

    c = s.add_curve("mod_cepstr", panel=0)
    assert len(c.times) == len(c.values) > 50
    s.add_curve("envelope", panel=0)
    s.add_curve("f0", panel=1, derivation=0)
    v = s.add_curve("mod_cepstr", panel=1, derivation=1, name="mod_vel")
    assert "mod_vel" in s.curves

    # textgrid
    tg = TextGrid(xmin=0, xmax=1.2)
    it = IntervalTier(name="words", xmax=1.2)
    it.add(0.1, 0.6, "ba")
    it.add(0.6, 1.1, "da")
    tg.tiers = [it]
    tgp = str(tmp_path / "utt.TextGrid")
    write_textgrid(tg, tgp)
    s.load_textgrid(tgp)

    # region + peaks (3 Hz AM on a 1.2 s file → ~4 envelope maxima)
    s.set_region(0.05, 1.15)
    res = s.analyze_max_peaks(panel=0)
    assert "mod_cepstr" in res
    assert len(res["mod_cepstr"][0]) >= 2
    s.analyze_min_peaks(panel=0)

    # CSV export with joins + aggregation
    out = str(tmp_path / "out.csv")
    s.export_csv(out, aggregate_tier="words")
    rows = list(csv.reader(open(out)))
    hdr = rows[0]
    assert any(h.endswith("_words") for h in hdr)
    assert "interval_label" in hdr
    assert "mod_cepstr_max_x" in hdr

    # render a figure
    png = str(tmp_path / "fig.png")
    s.render(out=png)
    assert os.path.getsize(png) > 10_000


def test_session_ema_flow(wav_path, tmp_path, rng):
    s = AnalysisSession(wav_path)
    pos = np.cumsum(rng.standard_normal((300, 8, 7)), axis=0).astype(np.float32)
    pp = str(tmp_path / "rec.pos")
    write_ag50x(pp, pos, 250)
    s.load_pos(pp)
    c = s.add_ema_curve(2, "z", panel=2)
    assert len(c.times) > 100
    cv = s.add_ema_curve(2, "z", panel=2, derivation=1)
    assert cv.name.endswith("_vel")
    # velocity should be roughly the diff of the trajectory
    approx = np.gradient(c.values)
    np.testing.assert_allclose(cv.values[5:-5], approx[5:-5], atol=1e-6)


def test_manual_peak_editing(wav_path):
    """CalculationValues/PointOperation parity: snap-to-nearest add/remove
    (reference quadruple_axis_plot_item.py:187-328, threshold 0.2 s)."""
    s = AnalysisSession(wav_path)
    c = s.add_curve("envelope", panel=0)
    t_mid = float(c.times[len(c.times) // 2])
    snapped = s.add_manual_peak("envelope", t_mid + 0.003, kind="max")
    assert snapped is not None
    t_snap, v = snapped
    assert abs(t_snap - t_mid) < 0.011
    assert len(c.max_peaks[0]) == 1
    # out-of-range click does nothing
    assert s.add_manual_peak("envelope", t_mid + 5.0) is None
    # remove snaps too
    assert s.remove_manual_peak("envelope", t_snap + 0.05, kind="max")
    assert len(c.max_peaks[0]) == 0
    assert not s.remove_manual_peak("envelope", t_mid, kind="max")


def test_extract_mfcc_alias():
    import numpy as np

    import modulation_mfcc as mm

    y = np.sin(2 * np.pi * 150 * np.arange(12000) / 10_000)
    t, m = mm.extract_mfcc(y)
    assert m.shape == (len(t), 13)
    tot, tt = mm.extract_modulation(y)
    assert tot.shape == tt.shape


def test_session_validation(wav_path):
    s = AnalysisSession(wav_path)
    with pytest.raises(ValueError, match="panel"):
        s.add_curve("envelope", panel=9)
    with pytest.raises(ValueError, match="region"):
        s.set_region(1.0, 0.5)
    with pytest.raises(RuntimeError, match="pos"):
        s.add_ema_curve(0)
    # no region → empty peak sets
    res = s.analyze_max_peaks()
    assert all(len(v[0]) == 0 for v in res.values())
