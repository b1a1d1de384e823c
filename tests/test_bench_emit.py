"""bench.py incremental artifact emission, wall budget and exit status.

The contract:

  * an artifact line is printed after EVERY completed field (last line
    wins), so a kill at any point keeps all finished fields;
  * in-process ``log_event`` records are silenced for the whole run so a
    corpus event can never be the last JSON line;
  * a total-wall budget (``MODMFCC_BENCH_TOTAL_TIMEOUT``) skips fields the
    remaining budget can't hold and records them in ``skipped_wall``;
  * per-field repeat stats ([min, median, max] over the timing trials, in
    metric units) land in ``repeat_stats``;
  * every line names the device; the final line stays under 2000 chars;
  * the exit status is non-zero when JAX finds no GPU or any field failed.

All asserted from subprocesses with the device check and the fields
stubbed (no card here) — SIGKILL ends the process.
"""
import json
import os
import signal
import subprocess
import sys
import time

REPO = __file__.rsplit("/tests/", 1)[0]


def _env(**extra):
    env = dict(os.environ)
    env.update({
        "JAX_PLATFORMS": "cpu",
        "PYTHONPATH": REPO + ":" + env.get("PYTHONPATH", ""),
    })
    env.update(extra)
    return env


def _art_lines(text):
    out = []
    for line in text.strip().splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            if rec.get("metric") == "mfcc_modulation_throughput":
                out.append(rec)
    return out


# Stubs the device check and every measured field with an instant fake (so
# the test needs no device and runs in seconds), except one slow field
# partway through the run — the SIGKILL target — and optionally one that
# raises.
STUB_SCRIPT = r"""
import sys, time
sys.path.insert(0, %(repo)r)
import bench

bench._device_info = lambda: {"platform": "gpu", "kind": "stub", "count": 1}

def _fake(val):
    def fn(*a, **k):
        bench._LAST_TRIALS[:] = [val - 1.0, val, val + 2.0]
        return val
    return fn

def _slow(*a, **k):
    print("SLOW_FIELD_STARTED", flush=True)
    time.sleep(%(slow_s)d)
    return 30.0

def _boom(*a, **k):
    raise RuntimeError("stub failure")

fakes = {
    "value": _fake(100.0), "matmul_bf16_rows": _fake(120.0),
    "matmul_i16": _fake(65.0), "matmul_i24_rows": _fake(63.0),
    "pyin_sweep_16k": _fake(2.6), "masked_batch_64": _slow,
    "corpus_sweep": _fake(0.3),
}
if %(fail)r:
    fakes["modspec_batch"] = _boom
bench.FIELDS = [
    (name, fakes.get(name, _fake(10.0)), (), cost)
    for name, _fn, _args, cost in bench.FIELDS
]
sys.exit(bench.main())
"""


def _stub(slow_s, fail=False):
    return STUB_SCRIPT % {"repo": REPO, "slow_s": slow_s, "fail": fail}


def test_sigkill_mid_run_keeps_completed_fields():
    """SIGKILL during a field: the last artifact line on stdout carries
    every already-completed field."""
    p = subprocess.Popen(
        [sys.executable, "-c", _stub(120)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=_env(),
    )
    lines = []
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            lines.append(line)
            if "SLOW_FIELD_STARTED" in line:
                break
        else:
            raise AssertionError("slow field never started")
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait(timeout=30)
    arts = _art_lines("".join(lines))
    assert arts, "no artifact line before the kill"
    last = arts[-1]
    # every field completed before the kill survives in the last line
    assert last["value"] == 100.0
    assert last["matmul_bf16_rows"] == 120.0
    assert last["matmul_i16"] == 65.0
    assert last["matmul_i24_rows"] == 63.0
    assert last["pyin_sweep_16k"] == 2.6
    assert last["masked_batch_64"] is None
    assert last["partial"] is True
    assert last["device"] == {"platform": "gpu", "kind": "stub", "count": 1}
    # repeat stats in metric units: [min, median, max]
    assert last["repeat_stats"]["value"] == [99.0, 100.0, 102.0]


def test_full_run_emits_incrementally_and_final_line_wins():
    r = subprocess.run(
        [sys.executable, "-c", _stub(0)],
        capture_output=True, text=True, timeout=300, env=_env(),
    )
    assert r.returncode == 0, r.stderr
    arts = _art_lines(r.stdout)
    # one line per completed field + the final emit
    assert len(arts) >= 15
    final = arts[-1]
    assert "partial" not in final
    assert final["value"] == 100.0
    assert final["masked_batch_64"] == 30.0
    assert final["corpus_sweep"] == 0.3
    assert "skipped_wall" not in final and "failed" not in final
    # every earlier line is marked partial
    assert all(a.get("partial") for a in arts[:-1])
    # the driver reads the tail: the artifact line must stay short
    last_line = [l for l in r.stdout.splitlines() if l.startswith("{")][-1]
    assert len(last_line) < 2000


def test_wall_budget_skips_and_records():
    """MODMFCC_BENCH_TOTAL_TIMEOUT=0: every field is skipped with a
    recorded reason; the run still produces a final artifact quickly."""
    r = subprocess.run(
        [sys.executable, "-c", _stub(120)],
        capture_output=True, text=True, timeout=300,
        env=_env(MODMFCC_BENCH_TOTAL_TIMEOUT="0"),
    )
    assert r.returncode == 0, r.stderr
    assert "SLOW_FIELD_STARTED" not in r.stdout  # never even started
    final = _art_lines(r.stdout)[-1]
    assert final["value"] is None
    assert "value" in final["skipped_wall"]
    assert "masked_batch_64" in final["skipped_wall"]


def test_failed_field_exits_nonzero():
    """A field that raises is listed in ``failed`` and turns the exit
    status to 1; the fields that ran are still in the final line."""
    r = subprocess.run(
        [sys.executable, "-c", _stub(0, fail=True)],
        capture_output=True, text=True, timeout=300, env=_env(),
    )
    assert r.returncode == 1, r.stderr
    final = _art_lines(r.stdout)[-1]
    assert final["failed"] == ["modspec_batch"]
    assert final["modspec_batch"] is None
    assert final["value"] == 100.0


def test_bench_refuses_cpu_backend():
    """On a CPU backend bench.py measures nothing, prints no artifact and
    exits non-zero — a CPU number is never reported as a device metric."""
    r = subprocess.run(
        [sys.executable, REPO + "/bench.py"],
        capture_output=True, text=True, timeout=120, env=_env(),
    )
    assert r.returncode == 2
    assert not _art_lines(r.stdout)
    assert "GPU" in r.stderr


def test_log_event_silenced_under_bench():
    """The artifact-line contract: with MODMFCC_LOG_SILENT set (bench sets
    it for its own process), log_event writes nothing."""
    script = (
        "import os; os.environ['MODMFCC_LOG_SILENT']='1';"
        "from modulation_mfcc.utils.obs import log_event;"
        "log_event('corpus.finish', items=1);"
        "del os.environ['MODMFCC_LOG_SILENT'];"
        "log_event('corpus.finish', items=2)"
    )
    r = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        timeout=120, env=_env(),
    )
    assert r.returncode == 0, r.stderr
    lines = [l for l in r.stderr.splitlines() if l.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0])["items"] == 2
