"""Per-section dialog metadata: derivation settings, enabled/name/panel,
channel selection — the config-surface keys the reference dialog persists
(reference script/config_dialog.py:604-725) beyond the DSP parameters."""
import json

import numpy as np
import pytest

from modulation_mfcc.io.wav import load_channel, write_wav
from modulation_mfcc.models.config import (
    DerivationConfig,
    MfccConfig,
    PipelineConfig,
    SectionMeta,
    config_from_reference_json,
    config_to_reference_json,
)
from modulation_mfcc.models.pipeline import resolve_derivation
from modulation_mfcc.models.workbench import AnalysisSession


def test_derivation_keys_roundtrip():
    """A JSON saved with 'f0 velocity, sg' must load back as exactly that —
    these keys were previously dropped on load (_SKIP_KEYS)."""
    src = {
        "f0": {
            "method": "praatac",
            "hopSize": 0.02,
            "enabled": True,
            "name": "myf0",
            "panel": 2,
            "derivation_type": 1,
            "derivative_method": "sg",
            "sg_width": 5,
            "fin_diff_acc_order": 4,
            "sg_poly_order": 3,
        }
    }
    cfg = config_from_reference_json(json.dumps(src))
    meta = cfg.meta_for("f0")
    assert meta.name == "myf0" and meta.panel == 2 and meta.enabled
    d = meta.derivation
    assert d.derivation_type == 1
    assert d.derivative_method == "sg"
    assert (d.sg_width, d.fin_diff_acc_order, d.sg_poly_order) == (5, 4, 3)
    assert cfg.f0.hopSize == 0.02

    # emit → reload is stable
    out = config_to_reference_json(cfg)
    assert out["f0"]["derivation_type"] == 1
    assert out["f0"]["derivative_method"] == "sg"
    assert out["f0"]["sg_width"] == 5
    cfg2 = config_from_reference_json(out)
    assert cfg2.meta_for("f0") == meta


def test_ema_section_shape():
    """The reference's ema section carries only the derivative keys — no
    enabled/name/panel/derivation_type (config_dialog.py:718-724)."""
    out = config_to_reference_json(PipelineConfig())
    ema = out["ema"]
    assert "derivative_method" in ema and "sg_width" in ema
    for absent in ("enabled", "name", "panel", "derivation_type"):
        assert absent not in ema
    # other sections do carry the full meta
    for key in ("enabled", "name", "panel", "derivation_type"):
        assert key in out["mfcc"]


def test_meta_for_unknown_section():
    with pytest.raises(ValueError):
        PipelineConfig().meta_for("nope")


def test_resolve_derivation_precedence():
    cfg = PipelineConfig(
        f0_meta=SectionMeta(
            derivation=DerivationConfig(derivation_type=2, derivative_method="sg")
        )
    )
    # unset → section settings
    deriv, dcfg = resolve_derivation("f0", cfg, None, None)
    assert deriv == 2 and dcfg.derivative_method == "sg"
    # explicit args override
    deriv, dcfg = resolve_derivation("f0", cfg, 0, DerivationConfig())
    assert deriv == 0 and dcfg.derivative_method == "gradient"
    # feature with no section → identity defaults
    deriv, dcfg = resolve_derivation("soundwave", cfg, None, None)
    assert deriv == 0


@pytest.fixture(scope="module")
def stereo_wav(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfgmeta")
    sr = 10_000
    t = np.arange(sr) / sr
    ch0 = 0.7 * np.sin(2 * np.pi * 200 * t)
    ch1 = 0.7 * np.sin(2 * np.pi * 900 * t)
    p = str(d / "stereo.wav")
    write_wav(p, np.stack([ch0, ch1]), sr)
    return p, sr


def test_load_channel_selects(stereo_wav):
    """channel_nb must actually select the channel (reference
    get_MFCCS_change: y = myAudio[channelN,:], script/mfcc.py:377-380)."""
    p, sr = stereo_wav
    y0 = load_channel(p, sr, 0)
    y1 = load_channel(p, sr, 1)
    assert y0.ndim == y1.ndim == 1
    # dominant frequency differs per channel
    f0 = np.argmax(np.abs(np.fft.rfft(y0))) * sr / len(y0)
    f1 = np.argmax(np.abs(np.fft.rfft(y1))) * sr / len(y1)
    assert abs(f0 - 200) < 5 and abs(f1 - 900) < 5


def test_channelN_reaches_pipeline(stereo_wav):
    """MfccConfig.channelN selects the analysis channel end-to-end."""
    from modulation_mfcc.models.pipeline import extract_feature

    p, _ = stereo_wav
    cfg0 = PipelineConfig(mfcc=MfccConfig())
    cfg1 = PipelineConfig(mfcc=MfccConfig(channelN=1))
    _, v0 = extract_feature(p, "mod_cepstr", cfg0)
    _, v1 = extract_feature(p, "mod_cepstr", cfg1)
    assert np.max(np.abs(np.asarray(v0) - np.asarray(v1))) > 1e-6


def test_session_uses_config_derivation(stereo_wav):
    """add_curve with no derivation args derives per the saved config — the
    previously-dropped keys now drive the curve (VERDICT round-1 item 4)."""
    p, _ = stereo_wav
    cfg = config_from_reference_json(
        {
            "amplitude": {
                "method": "RMS",
                "derivation_type": 1,
                "derivative_method": "gradient",
            }
        }
    )
    s = AnalysisSession(p, config=cfg)
    auto = s.add_curve("envelope", panel=0)
    explicit = s.add_curve("envelope", panel=0, derivation=1, name="explicit_vel")
    assert auto.derivation == 1
    assert auto.name == "envelope_vel"
    np.testing.assert_allclose(auto.values, explicit.values)
    # and an explicit 0 still overrides the config
    traj = s.add_curve("envelope", panel=0, derivation=0, name="traj")
    assert traj.derivation == 0
    assert np.max(np.abs(traj.values - auto.values)) > 1e-9
