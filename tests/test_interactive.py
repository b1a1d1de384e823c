"""Interactive HTML export: structure + embedded-data roundtrip."""
import json
import re

import numpy as np
import pytest

from modulation_mfcc.io.textgrid import IntervalTier, TextGrid, write_textgrid
from modulation_mfcc.io.wav import write_wav
from modulation_mfcc.models.workbench import AnalysisSession


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    d = tmp_path_factory.mktemp("ihtml")
    sr = 10_000
    t = np.arange(sr) / sr
    y = 0.7 * np.sin(2 * np.pi * 150 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    p = str(d / "utt.wav")
    write_wav(p, y, sr)
    tg = TextGrid(xmin=0, xmax=1.0)
    it = IntervalTier(name="words", xmax=1.0)
    it.add(0.1, 0.5, "ba")
    it.add(0.5, 0.9, "na")
    tg.tiers.append(it)
    tgp = str(d / "utt.TextGrid")
    write_textgrid(tg, tgp)
    s = AnalysisSession(p)
    s.load_textgrid(tgp)
    s.add_curve("mod_cepstr", panel=0)
    s.add_curve("envelope", panel=1)
    s.set_region(0.2, 0.6)
    s.analyze_max_peaks(0)
    return s


def _embedded_data(html: str) -> dict:
    m = re.search(r"const DATA = (\{.*?\});\n", html, re.S)
    assert m, "embedded DATA blob missing"
    return json.loads(m.group(1))


def test_export_structure(session, tmp_path):
    out = session.render_interactive(str(tmp_path / "view.html"))
    html = open(out).read()
    data = _embedded_data(html)
    assert data["duration"] == pytest.approx(1.0)
    assert data["region"] == [0.2, 0.6]
    assert len(data["panels"]) == 2
    names = [c["name"] for p in data["panels"] for c in p]
    assert "mod_cepstr" in names and "envelope" in names
    mc = data["panels"][0][0]
    assert len(mc["x"]) == len(mc["y"]) > 50
    assert all(v is None or np.isfinite(v) for v in mc["y"])
    assert len(mc["maxPeaks"][0]) > 0  # analyzed peaks embedded
    assert data["tiers"][0]["intervals"][0][2] == "ba"
    assert len(data["wave"]["t"]) == len(data["wave"]["lo"]) == len(data["wave"]["hi"])
    # interaction handlers present (crosshair/zoom/sync cursor)
    for token in ("mousemove", "dblclick", "wheel", "zreset", "spectoggle", "cursorT"):
        assert token in html
    # spectrogram embedded as a data URI
    assert "data:image/png;base64," in html


def test_export_without_spectrogram(session, tmp_path):
    out = session.render_interactive(
        str(tmp_path / "nospec.html"), show_spectrogram=False
    )
    html = open(out).read()
    assert "data:image/png;base64," not in html
