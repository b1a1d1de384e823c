#!/usr/bin/env python
"""Smoke run of the extraction library on NVIDIA GPUs, at sizes users run.

    python chip_smoke.py          # one card: every main path
    python chip_smoke.py --four   # four cards: the sharded paths only

Run from the repository root. Each phase prints its own lines (timings,
``memory_analysis()``, parity against the float64 oracles at the stated
tolerances); any failure exits non-zero. The last line of a passing run is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Phase 0 runs before JAX is imported: the cards' name and power limit from
``nvidia-smi``, a rebuild of ``native/`` from source, and (one card) the
card-only tests, ``pytest -m gpu``, in a child process while this process
holds no device memory. Phase 1 refuses anything but a GPU: there is no CPU
fallback. The later phases are functions of their sizes, so the test suite
runs each at a tiny size on the CPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# stated tolerances of each spectrum tier at the mfcc_change output, vs the
# float64 oracle (runner.run_verify's 1e-4 bar; bf16 is corpus grade)
TIER_TOL = {
    "fft": 1e-4, "matmul": 1e-4, "matmul_x3": 1e-4, "matmul_i24": 1e-4,
    "matmul_i16": 1e-4, "matmul_bf16": 1e-1,
}


class SmokeFailure(RuntimeError):
    """A phase's result is wrong (as opposed to crashing)."""


def say(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}, default=_jsonable), flush=True)


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    return str(v)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# phase 0 (no JAX in this process)


def phase0_prelude(run_gpu_tests: bool) -> None:
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        raise SmokeFailure("nvidia-smi not found: no NVIDIA driver here") from None
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi found no card")
    for line in smi.stdout.strip().splitlines():
        print(f"card: {line.strip()}", flush=True)
    t0 = time.perf_counter()
    mk = subprocess.run(["make", "-C", os.path.join(REPO, "native"), "-B"],
                        capture_output=True, text=True, timeout=300)
    check(mk.returncode == 0, f"native build failed: {mk.stderr[-2000:]}")
    say("native_build", seconds=round(time.perf_counter() - t0, 2))
    if not run_gpu_tests:
        return
    t0 = time.perf_counter()
    env = dict(os.environ, MODMFCC_TEST_GPU="1")
    pt = subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
         "-p", "no:cacheprovider"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    tail = pt.stdout.strip().splitlines()[-1:] or [""]
    say("gpu_tests", rc=pt.returncode, summary=tail[0],
        seconds=round(time.perf_counter() - t0, 2))
    check(pt.returncode == 0, f"pytest -m gpu failed:\n{pt.stdout[-3000:]}")


# ---------------------------------------------------------------------------
# phase 1


def phase1_device(n_cards: int = 1) -> dict:
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU — JAX runs on {devs[0].platform}",
              file=sys.stderr)
        raise SystemExit(1)
    check(len(devs) >= n_cards, f"needs {n_cards} cards, JAX has {len(devs)}")
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    say("device", **info)
    return info


# ---------------------------------------------------------------------------
# shared helpers


def speech_batch(key_seed: int, batch: int, n: int, sr: int, pcm16: bool = True):
    """Device-generated speech-like rows [batch, n] float32: five
    harmonics of a per-row gliding f0, syllable-rate AM, a −40 dB noise
    floor; ``pcm16`` puts them on the int16 grid (the corpus format)."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def gen(key):
        k1, k2, k3 = jax.random.split(key, 3)
        f_base = jax.random.uniform(k1, (batch, 1), minval=90.0, maxval=220.0)
        am = jax.random.uniform(k2, (batch, 1), minval=2.0, maxval=6.0)
        t = jnp.arange(n, dtype=jnp.float32)[None, :] / sr
        f0 = f_base * (1.0 + 0.15 * jnp.sin(2 * jnp.pi * 0.7 * t))
        phase = 2 * jnp.pi * jnp.cumsum(f0, axis=-1) / sr
        sig = sum((0.5 / k) * jnp.sin(k * phase) for k in range(1, 6))
        env = 0.5 * (1.0 + jnp.sin(2 * jnp.pi * am * t))
        y = 0.6 * sig * env + 0.01 * jax.random.normal(k3, (batch, n))
        if pcm16:
            y = jnp.round(jnp.clip(y, -1.0, 32767 / 32768) * 32768.0) / 32768.0
        return y.astype(jnp.float32)

    return gen(jax.random.PRNGKey(key_seed))


def warm_times(fn, inputs, trials: int = 3) -> list:
    """Wall seconds of ``fn`` on distinct inputs, each ended by
    block_until_ready (the first input is the warm-up and not timed)."""
    import jax

    jax.block_until_ready(fn(inputs[0]))
    out = []
    for i in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(inputs[1 + i % (len(inputs) - 1)]))
        out.append(round(time.perf_counter() - t0, 5))
    return out


def memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    if ma is None:
        return {}
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k.replace("_in_bytes", "_mb"): round(getattr(ma, k, 0) / 1e6, 2)
            for k in keys}


def _max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


# ---------------------------------------------------------------------------
# phase 2: flagship mfcc_change, every spectrum tier


def phase2_flagship(batch: int = 128, seconds: float = 30.0, sr: int = 16_000,
                    spectra=tuple(TIER_TOL), rows_spectrum: str = "matmul_i16",
                    n_check: int = 2, trials: int = 3) -> dict:
    import jax

    from modulation_mfcc.models.config import MfccConfig
    from modulation_mfcc.models.modulation import (
        _mfcc_change_jit,
        extract_mfcc_change,
        min_frames_for_fir,
    )
    from modulation_mfcc.ops.framing import pack_hop_rows
    from modulation_mfcc.oracle import get_mfccs_change_np
    from modulation_mfcc.parallel.batch import AudioBatch, batched_mfcc_change

    cfg = MfccConfig(signal_sample_rate=sr, maxFreq=min(10_000.0, sr / 2.0))
    n = int(seconds * sr)
    xs = [speech_batch(s, batch, n, sr) for s in (11, 12, 13)]
    rows_check = np.asarray(xs[0][:n_check], np.float64)
    want = [get_mfccs_change_np(r, float(sr), max_freq=cfg.maxFreq)[0]
            for r in rows_check]
    hours = batch * seconds / 3600.0
    flat = {}
    for sp in spectra:
        t0 = time.perf_counter()
        compiled = _mfcc_change_jit.lower(xs[0], cfg, True, sp).compile()
        compile_s = round(time.perf_counter() - t0, 2)
        got = np.asarray(extract_mfcc_change(xs[0], cfg, spectrum=sp)[0])
        errs = [_max_err(got[i], want[i]) for i in range(n_check)]
        ts = warm_times(lambda x, sp=sp: extract_mfcc_change(x, cfg, spectrum=sp)[0],
                        xs, trials)
        flat[sp] = got
        ok = max(errs) <= TIER_TOL[sp]
        say("flagship", spectrum=sp, batch=batch, seconds=seconds, sr=sr,
            compile_s=compile_s, warm_s=ts, audio_h_per_s=round(hours / min(ts), 3),
            max_abs_err=max(errs), tolerance=TIER_TOL[sp], parity=ok,
            memory=memory(compiled))
        check(ok, f"flagship {sp}: max err {max(errs)} > {TIER_TOL[sp]}")
    if rows_spectrum:
        to_rows = jax.jit(lambda x: pack_hop_rows(
            jax.numpy.round(x * 32768.0).astype(jax.numpy.int16),
            n_fft=cfg.n_fft, hop=cfg.hop_length))
        rows = [to_rows(x) for x in xs]
        lengths = jax.numpy.full((batch,), n, jax.numpy.int32)
        fir_ok = 1 + n // cfg.hop_length >= min_frames_for_fir(cfg)
        run = jax.jit(lambda r: batched_mfcc_change(
            AudioBatch(r, lengths), cfg, spectrum=rows_spectrum,
            masked_fir=fir_ok, n_samples=n)[0])
        t0 = time.perf_counter()
        compiled = run.lower(rows[0]).compile()
        compile_s = round(time.perf_counter() - t0, 2)
        got = np.asarray(run(rows[0]))
        errs = [_max_err(got[i], want[i]) for i in range(n_check)]
        vs_flat = _max_err(got, flat[rows_spectrum]) if rows_spectrum in flat else 0.0
        ts = warm_times(run, rows, trials)
        ok = max(errs) <= TIER_TOL[rows_spectrum] and vs_flat <= 1e-5
        say("flagship_rows", spectrum=rows_spectrum, compile_s=compile_s,
            warm_s=ts, audio_h_per_s=round(hours / min(ts), 3),
            max_abs_err=max(errs), vs_flat=vs_flat, parity=ok,
            memory=memory(compiled))
        check(ok, f"hop-rows {rows_spectrum}: err {max(errs)}, vs flat {vs_flat}")
    return flat


# ---------------------------------------------------------------------------
# phase 3: the parity harness


def phase3_verify(srs=(10_000, 16_000), seconds: float = 2.0) -> None:
    import contextlib
    import io
    from types import SimpleNamespace

    from modulation_mfcc.runner import run_verify

    for sr in srs:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = run_verify(SimpleNamespace(wav=None, seconds=seconds, sr=sr))
        lines = [json.loads(l) for l in buf.getvalue().splitlines() if l.startswith("{")]
        surfaces = {l["surface"]: l["pass"] for l in lines if "surface" in l}
        say("verify", sr=sr, rc=rc, seconds=round(time.perf_counter() - t0, 2),
            surfaces=surfaces)
        failed = [k for k, v in surfaces.items() if not v]
        check(rc == 0 and not failed and surfaces,
              f"run_verify at {sr} Hz failed: {failed}; {buf.getvalue()[-3000:]}")


# ---------------------------------------------------------------------------
# phase 4: variable-length batch (masked FIR path)


def phase4_variable_length(n_files: int = 64, min_s: float = 8.0,
                           max_s: float = 30.0, sr: int = 16_000) -> None:
    import jax

    from modulation_mfcc.models.config import MfccConfig
    from modulation_mfcc.models.modulation import extract_mfcc_change
    from modulation_mfcc.parallel.batch import batched_mfcc_change, pad_batch

    cfg = MfccConfig(signal_sample_rate=sr, maxFreq=min(10_000.0, sr / 2.0))
    rng = np.random.default_rng(4)
    lengths = rng.integers(int(min_s * sr), int(max_s * sr), size=n_files)
    pool = np.asarray(speech_batch(21, n_files, int(max_s * sr), sr))
    sigs = [pool[i, :L] for i, L in enumerate(lengths)]
    batch = pad_batch(sigs, bucket_multiple=16_384)
    run = jax.jit(lambda b: batched_mfcc_change(b, cfg, masked_fir=True))
    t0 = time.perf_counter()
    tot, _mask = jax.block_until_ready(run(batch))
    first_s = round(time.perf_counter() - t0, 2)
    ts = warm_times(lambda b: run(b)[0], [batch, batch], trials=2)
    tot = np.asarray(tot)
    bucket = batch.samples.shape[-1]  # one compiled single-file program
    worst = 0.0
    for i, s in enumerate(sigs):
        single, _ = extract_mfcc_change(s, cfg, bucket=bucket)
        single = np.asarray(single)
        worst = max(worst, _max_err(tot[i, : single.shape[0]], single))
    ok = worst <= 1e-4
    say("variable_length", files=n_files, first_call_s=first_s, warm_s=ts,
        audio_h=round(float(lengths.sum()) / sr / 3600, 4),
        max_abs_vs_single=worst, tolerance=1e-4, parity=ok)
    check(ok, f"masked batch != single file: {worst}")


# ---------------------------------------------------------------------------
# phase 5: trackers


def _voicing_and_hz(got, want, min_agree=0.99, p99_hz=0.2):
    got_v = np.nan_to_num(got, nan=0.0) > 20
    want_v = np.nan_to_num(want, nan=0.0) > 20
    agree = float(np.mean(got_v == want_v))
    both = got_v & want_v
    p99 = float(np.quantile(np.abs(got[both] - want[both]), 0.99)) if both.any() else 0.0
    return {"voicing_agreement": agree, "p99_voiced_hz": p99,
            "pass": agree >= min_agree and p99 <= p99_hz}


def _pyin_bins(got, want):
    """pyin bars: ≥99% identical voicing, and ≥99% of the commonly voiced
    frames on the identical pitch bin (same f0 to 1e-5 relative)."""
    got_v, want_v = got > 0, want > 0
    agree = float(np.mean(got_v == want_v))
    both = got_v & want_v
    same = float(np.mean(np.abs(got[both] / want[both] - 1.0) <= 1e-5)) if both.any() else 1.0
    return {"voicing_agreement": agree, "same_bin": same,
            "pass": agree >= 0.99 and same >= 0.99}


def phase5_trackers(batch: int = 16, seconds: float = 30.0, sr: int = 10_000,
                    pyin_batch: int = 8, pyin_rates=(10_000, 16_000),
                    oracle_seconds: float = 10.0) -> None:
    """Pitch ac, formants, envelope and intensity on ``batch`` rows at
    ``sr``, pyin on ``pyin_batch`` rows at each rate; one row of each is
    compared with its float64 oracle on its first ``oracle_seconds``
    (a separate single-row call, so the oracle's Python loops stay short)."""
    import jax
    import jax.numpy as jnp

    from modulation_mfcc import oracle
    from modulation_mfcc.models.envelope import rms_envelope
    from modulation_mfcc.ops.intensity import intensity_db
    from modulation_mfcc.ops.lpc import lpc_formants
    from modulation_mfcc.ops.pitch import pitch_ac
    from modulation_mfcc.ops.yin import pyin_f0

    n = int(seconds * sr)
    xs = [speech_batch(s, batch, n, sr) for s in (31, 32, 33)]
    fns = {
        "pitch_ac": jax.jit(jax.vmap(lambda y: pitch_ac(y, sr=float(sr)))),
        "formants": jax.jit(jax.vmap(lambda y: lpc_formants(y, sr=float(sr))[0])),
        "envelope": jax.jit(jax.vmap(lambda y: rms_envelope(y, 250, 50))),
        "intensity": jax.jit(jax.vmap(lambda y: intensity_db(y, sr=float(sr)))),
    }
    for name, fn in fns.items():
        ts = warm_times(fn, xs, trials=2)
        check(bool(np.isfinite(np.nan_to_num(np.asarray(fn(xs[0])))).all()),
              f"{name} not finite")
        say("tracker", name=name, batch=batch, seconds=seconds, sr=sr, warm_s=ts,
            audio_h_per_s=round(batch * seconds / 3600 / min(ts), 3))
    m = int(oracle_seconds * sr)
    y1 = np.asarray(xs[0][0, :m], np.float64)
    yj = jnp.asarray(y1, jnp.float32)
    res = {"pitch_ac": _voicing_and_hz(np.asarray(pitch_ac(yj, sr=float(sr))),
                                       oracle.boersma_pitch_np(y1, float(sr)))}
    _, want_db = oracle.praat_intensity_np(y1, float(sr))
    got_db = np.asarray(intensity_db(yj, sr=float(sr)))
    err_db = _max_err(got_db, want_db) if got_db.shape == want_db.shape else float("inf")
    res["intensity"] = {"max_abs_db": err_db, "pass": err_db <= 0.01}
    # formant ceiling at Nyquist for the comparison, as runner.run_verify
    _, want_f, _ = oracle.praat_formants_np(y1, float(sr), max_formant=sr / 2)
    got_f = np.asarray(lpc_formants(yj, sr=float(sr), max_formant=sr / 2)[0])
    if got_f.shape == want_f.shape:
        same = np.isfinite(got_f) == np.isfinite(want_f)
        both = np.isfinite(got_f) & np.isfinite(want_f)
        p99 = float(np.quantile(np.abs(got_f[both] - want_f[both]), 0.99)) if both.any() else 0.0
        res["formants"] = {"pattern_agreement": float(same.all(axis=-1).mean()),
                           "p99_hz": p99,
                           "pass": same.all(axis=-1).mean() >= 0.99 and p99 <= 2.0}
    else:
        res["formants"] = {"shape": [got_f.shape, want_f.shape], "pass": False}
    env = np.asarray(rms_envelope(yj, 250, 50), np.float64)
    fr = np.lib.stride_tricks.sliding_window_view(np.pad(y1, 125), 250)[::50]
    fr = fr[: env.shape[-1]]
    err_env = _max_err(env, np.sqrt(np.mean(fr * fr, axis=-1)))
    res["envelope"] = {"max_abs_err": err_env, "pass": err_env <= 1e-4}
    for rate in pyin_rates:
        npy = int(seconds * rate)
        ps = [speech_batch(s, pyin_batch, npy, rate) for s in (41, 42, 43)]
        fn = jax.jit(jax.vmap(lambda y, rate=rate: pyin_f0(y, sr=float(rate))))
        ts = warm_times(fn, ps, trials=2)
        say("tracker", name="pyin", batch=pyin_batch, seconds=seconds, sr=rate,
            warm_s=ts, audio_h_per_s=round(pyin_batch * seconds / 3600 / min(ts), 3))
        yp = np.asarray(ps[0][0, : int(oracle_seconds * rate)], np.float64)
        of0, _ov, _ = oracle.pyin_np(yp, rate, hop_length=int(round(0.01 * rate)))
        jf0 = np.asarray(pyin_f0(jnp.asarray(yp, jnp.float32), sr=float(rate)))
        res[f"pyin_{rate}"] = _pyin_bins(jf0, of0)
    say("tracker_parity", sr=sr, oracle_seconds=oracle_seconds, results=res)
    failed = [k for k, v in res.items() if not v["pass"]]
    check(not failed, f"tracker parity failed: {failed}")


# ---------------------------------------------------------------------------
# phase 6: long form


def phase6_longform(hours: float = 1.0, sr_in: int = 48_000,
                    check_seconds: float = 300.0, sr: int = 16_000,
                    longform_threshold: int | None = None) -> None:
    """``longform_threshold`` lowers extract_mfcc_change's switch to the
    chunked path (the test suite's tiny run); None keeps the library's."""
    import jax

    from modulation_mfcc.models.config import MfccConfig
    from modulation_mfcc.models.modulation import _mfcc_change_jit, extract_mfcc_change
    from modulation_mfcc.ops.resample import resample_device
    from modulation_mfcc.parallel.streaming import chunked_mfcc_change

    cfg = MfccConfig(signal_sample_rate=sr, maxFreq=min(10_000.0, sr / 2.0))
    n_in = int(hours * 3600 * sr_in)
    ys = [speech_batch(s, 1, n_in, sr_in, pcm16=False)[0] for s in (51, 52)]
    resample = jax.jit(lambda y: resample_device(y, float(sr_in), float(sr)))

    kw = {} if longform_threshold is None else {"longform_threshold": longform_threshold}

    def run(y):
        return extract_mfcc_change(resample(y), cfg, **kw)[0]

    t0 = time.perf_counter()
    out = jax.block_until_ready(run(ys[0]))
    first_s = round(time.perf_counter() - t0, 2)
    ts = warm_times(run, ys, trials=1)
    y16 = resample(ys[0])
    mem_r = memory(resample.lower(ys[0]).compile())
    mem_c = memory(chunked_mfcc_change.lower(y16, cfg).compile())
    ok_finite = bool(np.isfinite(np.asarray(out)).all())
    say("longform", hours=hours, sr_in=sr_in, frames=int(out.shape[0]),
        first_call_s=first_s, warm_s=ts, memory_resample=mem_r,
        memory_chunked=mem_c, finite=ok_finite)
    check(ok_finite, "long-form output not finite")
    m = int(check_seconds * sr)
    part = y16[:m]
    chunked = np.asarray(chunked_mfcc_change(part, cfg))
    whole = np.asarray(_mfcc_change_jit(part[None], cfg, True, "fft"))[0]
    err = _max_err(chunked, whole)
    say("longform_chunked_vs_whole", seconds=check_seconds, max_abs_err=err,
        tolerance=1e-4, parity=err <= 1e-4)
    check(err <= 1e-4, f"chunked != unchunked: {err}")


# ---------------------------------------------------------------------------
# phase 7: corpus sweep


def write_corpus(root: str, n_files: int, seconds: float, sr: int, seed: int = 61) -> list:
    from modulation_mfcc.io.wav import write_wav

    ys = np.asarray(speech_batch(seed, n_files, int(seconds * sr), sr))
    paths = []
    for i in range(n_files):
        p = os.path.join(root, f"utt_{i:04d}.wav")
        write_wav(p, ys[i], sr)
        paths.append(p)
    return paths


def _sweep(paths, out_dir, cfg, mesh=None, features=("mod_cepstr",)):
    from modulation_mfcc.parallel.corpus import CorpusSweep, sweep_mfcc_change

    sweep = CorpusSweep(out_dir=out_dir, cfg=cfg, batch_size=32, spectrum="auto",
                        resume=False, features=tuple(features), mesh=mesh)
    t0 = time.perf_counter()
    report = sweep_mfcc_change(paths, sweep)
    return time.perf_counter() - t0, report


def phase7_corpus(n_files: int = 96, seconds: float = 30.0, sr: int = 16_000,
                  n_check: int = 3, root: str | None = None) -> None:
    from modulation_mfcc.io.wav import load_channel
    from modulation_mfcc.models.config import MfccConfig
    from modulation_mfcc.models.modulation import extract_mfcc_change

    cfg = MfccConfig(signal_sample_rate=sr, maxFreq=min(10_000.0, sr / 2.0))
    feats = ("mod_cepstr", "f0", "envelope", "formants")
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        paths = write_corpus(tmp, n_files, seconds, sr)
        wall, report = _sweep(paths, os.path.join(tmp, "out"), cfg, features=feats)
        outs = [os.path.join(tmp, "out", f"utt_{i:04d}.npz") for i in range(n_files)]
        written = sum(os.path.exists(p) for p in outs)
        worst = 0.0
        for i in range(n_check):
            rec = np.load(outs[i])
            check(all(k in rec for k in ("f0", "envelope", "formants")),
                  f"npz {i} lacks a feature: {list(rec)}")
            y = load_channel(paths[i], sr)
            single = np.asarray(extract_mfcc_change(y, cfg, spectrum="matmul")[0])
            worst = max(worst, _max_err(rec["mod_cepstr"], single))
        ok = written == n_files and worst <= 1e-4
        say("corpus", files=n_files, seconds_each=seconds, features=list(feats),
            wall_s=round(wall, 2), audio_h_per_wall_s=round(n_files * seconds / 3600 / wall, 4),
            npz_written=written, max_abs_vs_single=worst, tolerance=1e-4,
            stages=report.get("stages"), parity=ok)
        check(ok, f"corpus: {written}/{n_files} written, err {worst}")


# ---------------------------------------------------------------------------
# --four: the sharded paths against one card


def phase_four_data_parallel(batch: int = 128, seconds: float = 30.0, sr: int = 16_000,
                             n_cards: int = 4) -> None:
    import jax

    from modulation_mfcc.models.config import MfccConfig
    from modulation_mfcc.models.modulation import min_frames_for_fir
    from modulation_mfcc.parallel.batch import (
        AudioBatch,
        batched_mfcc_change,
        sharded_mfcc_change,
    )
    from modulation_mfcc.parallel.mesh import data_sharding, make_mesh

    cfg = MfccConfig(signal_sample_rate=sr, maxFreq=min(10_000.0, sr / 2.0))
    n = int(seconds * sr)
    lengths = jax.numpy.asarray(
        np.random.default_rng(7).integers(n // 3, n + 1, size=batch).astype(np.int32))
    xs = [speech_batch(s, batch, n, sr) for s in (71, 72)]
    fir_ok = 1 + int(lengths.min()) // cfg.hop_length >= min_frames_for_fir(cfg)
    one = jax.jit(lambda x: batched_mfcc_change(
        AudioBatch(x, lengths), cfg, masked_fir=fir_ok)[0])
    want = np.asarray(one(xs[0]))
    mesh = make_mesh(n_cards, 1)
    xs_sh = [jax.device_put(x, data_sharding(mesh, 2)) for x in xs]
    l_sh = jax.device_put(lengths, data_sharding(mesh, 1))

    def sharded(x):
        return sharded_mfcc_change(AudioBatch(x, l_sh), cfg, mesh, masked_fir=fir_ok)[0]

    got = np.asarray(sharded(xs_sh[0]))
    ts = warm_times(sharded, xs_sh, trials=2)
    t1 = warm_times(one, xs, trials=2)
    mask = np.arange(want.shape[-1])[None, :] < (1 + np.asarray(lengths) // cfg.hop_length)[:, None]
    err = _max_err(np.where(mask, got, 0.0), np.where(mask, want, 0.0))
    say("four_data_parallel", cards=n_cards, batch=batch, seconds=seconds,
        warm_s_sharded=ts, warm_s_one_card=t1, max_abs_vs_one_card=err,
        tolerance=1e-5, parity=err <= 1e-5)
    check(err <= 1e-5, f"data-parallel != one card: {err}")


def phase_four_longform(hours: float = 1.0, sr: int = 16_000, n_cards: int = 4) -> None:
    import jax

    from modulation_mfcc.models.config import MfccConfig
    from modulation_mfcc.parallel.mesh import make_mesh
    from modulation_mfcc.parallel.streaming import (
        chunked_mfcc_change,
        sharded_longform_mfcc_change,
    )

    cfg = MfccConfig(signal_sample_rate=sr, maxFreq=min(10_000.0, sr / 2.0))
    n = int(hours * 3600 * sr)
    ys = [speech_batch(s, 1, n, sr, pcm16=False)[0] for s in (81, 82)]
    want = np.asarray(chunked_mfcc_change(ys[0], cfg))
    t1 = warm_times(lambda y: chunked_mfcc_change(y, cfg), ys, trials=1)
    mesh = make_mesh(1, n_cards)
    run = jax.jit(lambda y: sharded_longform_mfcc_change(y, cfg, mesh))
    got = np.asarray(run(ys[0]))
    ts = warm_times(run, ys, trials=1)
    err = _max_err(got, want)
    say("four_longform", cards=n_cards, hours=hours, warm_s_sharded=ts,
        warm_s_one_card=t1, max_abs_vs_one_card=err, tolerance=1e-4,
        parity=err <= 1e-4)
    check(err <= 1e-4, f"time-sharded long form != one card: {err}")


def phase_four_corpus(n_files: int = 96, seconds: float = 30.0, sr: int = 16_000,
                      n_cards: int = 4, root: str | None = None) -> None:
    import jax

    from modulation_mfcc.models.config import MfccConfig
    from modulation_mfcc.parallel.mesh import make_mesh

    cfg = MfccConfig(signal_sample_rate=sr, maxFreq=min(10_000.0, sr / 2.0))
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        paths = write_corpus(tmp, n_files, seconds, sr)
        wall1, _ = _sweep(paths, os.path.join(tmp, "one"), cfg,
                          mesh=make_mesh(1, 1, devices=jax.devices()[:1]))
        wall4, _ = _sweep(paths, os.path.join(tmp, "four"), cfg,
                          mesh=make_mesh(n_cards, 1))
        worst = 0.0
        for i in range(n_files):
            a = np.load(os.path.join(tmp, "one", f"utt_{i:04d}.npz"))["mod_cepstr"]
            b = np.load(os.path.join(tmp, "four", f"utt_{i:04d}.npz"))["mod_cepstr"]
            check(a.shape == b.shape, f"npz {i}: shape {a.shape} vs {b.shape}")
            worst = max(worst, _max_err(a, b))
    say("four_corpus", cards=n_cards, files=n_files, wall_s_one_card=round(wall1, 2),
        wall_s_four=round(wall4, 2), max_abs_vs_one_card=worst, tolerance=1e-5,
        parity=worst <= 1e-5)
    check(worst <= 1e-5, f"4-card corpus != one card: {worst}")


# ---------------------------------------------------------------------------


def main(argv: list[str]) -> int:
    four = "--four" in argv
    t_start = time.perf_counter()
    try:
        phase0_prelude(run_gpu_tests=not four)
        info = phase1_device(4 if four else 1)
        if four:
            phase_four_data_parallel()
            phase_four_longform()
            phase_four_corpus()
        else:
            phase2_flagship()
            phase3_verify()
            phase4_variable_length()
            phase5_trackers()
            phase6_longform()
            phase7_corpus()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    say("done", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
