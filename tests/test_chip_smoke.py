"""chip_smoke.py: each phase at a tiny size on the CPU, and its refusals.

On the card the script runs every phase at the sizes users run; here each
phase function runs at a size that compiles and checks in seconds, so a
wrong path, argument or comparison shows before a chip call. The four-card
phases run on four of the suite's virtual CPU devices.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

import jax

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402


def _ok_line(stdout: str) -> bool:
    lines = [l for l in stdout.strip().splitlines() if l.startswith("{")]
    return bool(lines) and json.loads(lines[-1]).get("ok") is True


def test_device_phase_refuses_cpu_backend():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as e:
        chip_smoke.phase1_device()
    assert e.value.code == 1


@pytest.mark.parametrize("alone", [False, True], ids=["in_repo", "script_alone"])
def test_script_fails_without_card(tmp_path, alone):
    """No card (and, alone, none of the repo): non-zero exit, no result."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], cwd=str(script.parent),
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode != 0
    assert not _ok_line(r.stdout)


def test_phase2_flagship_tiny(capsys):
    flat = chip_smoke.phase2_flagship(batch=2, seconds=4.0, n_check=2, trials=1)
    assert set(flat) == set(chip_smoke.TIER_TOL)
    out = capsys.readouterr().out
    assert out.count('"phase": "flagship"') == len(chip_smoke.TIER_TOL)
    assert '"phase": "flagship_rows"' in out


def test_phase3_verify_tiny():
    chip_smoke.phase3_verify(srs=(10_000,), seconds=2.0)


def test_phase4_variable_length_tiny():
    chip_smoke.phase4_variable_length(n_files=3, min_s=3.8, max_s=4.6)


def test_phase5_trackers_tiny():
    chip_smoke.phase5_trackers(batch=2, seconds=2.0, pyin_batch=2,
                               pyin_rates=(10_000,), oracle_seconds=2.0)


def test_phase6_longform_tiny(capsys):
    chip_smoke.phase6_longform(hours=6.0 / 3600, check_seconds=4.0,
                               longform_threshold=16_000)
    out = capsys.readouterr().out
    assert '"memory_chunked"' in out


def test_phase7_corpus_tiny(tmp_path):
    chip_smoke.phase7_corpus(n_files=3, seconds=4.0, n_check=2, root=str(tmp_path))


def test_four_card_phases_on_virtual_devices(tmp_path):
    assert len(jax.devices()) >= 4
    chip_smoke.phase_four_data_parallel(batch=4, seconds=1.0)
    chip_smoke.phase_four_longform(hours=8.0 / 3600)
    chip_smoke.phase_four_corpus(n_files=4, seconds=1.0, root=str(tmp_path))
