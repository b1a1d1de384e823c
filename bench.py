#!/usr/bin/env python
"""Throughput benchmark of the extraction paths on one GPU.

Prints one JSON line after every completed field; the LAST line is the
artifact (earlier lines carry ``"partial": true``, so a run cut short still
leaves every finished field). Every line names the device it ran on.

Fields, audio-hours per second unless noted (16 kHz, 128 × 30 s batches
through ``mfcc_change`` unless noted):
  * ``value`` — the headline, spectrum ``matmul_bf16`` (corpus grade);
  * one field per spectrum tier (``matmul``, ``matmul_x3``, ``matmul_i24``,
    ``matmul_i16``, ``fft``) and ``*_rows`` from the hop-rows at-rest
    contract for the tiers that take int16 or f32 rows;
  * ``tracker_sweep`` (pitch ac + formants + RMS envelope + intensity,
    16 × 30 s at 10 kHz), ``pyin_sweep`` / ``pyin_sweep_16k`` (8 × 30 s);
  * ``masked_batch_64`` (64 files of 8-30 s, real audio in the numerator),
    ``modspec_batch`` (modulation spectrum);
  * ``longform_1h_s`` (one hour at 48 kHz, resample + chunked, seconds);
  * ``corpus_sweep`` (96 WAVs on disk → npz, wall clock, + stage stats).

Timing: inputs are generated on the device, each program is compiled and
warmed on one input, then timed on distinct inputs with
``block_until_ready``; ``repeat_stats`` keeps [min, median, max] of the
trials. ``MODMFCC_BENCH_TOTAL_TIMEOUT`` (seconds, default 2400) skips
fields the remaining budget cannot hold and lists them in ``skipped_wall``.

Exit status: 2 when JAX finds no GPU (nothing is measured), 1 when any
field failed (the fields that ran are still printed), 0 otherwise.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

# per-trial values of the most recent field, in metric units
_LAST_TRIALS: list = []
# stage breakdown of the last corpus run (artifact field)
_LAST_CORPUS_STATS: dict = {}

SR = 16_000
BATCH, SECONDS = 128, 30.0


def _time_warm(fn, xs, trials: int = 5) -> float:
    """Best wall seconds of ``fn`` over ``trials`` calls on distinct inputs
    (compiled and warmed on ``xs[0]`` first); every trial lands in
    _LAST_TRIALS."""
    import jax

    jax.block_until_ready(xs)
    jax.block_until_ready(fn(xs[0]))  # compile + warm
    _LAST_TRIALS.clear()
    for i in range(trials):
        x = xs[1 + i % (len(xs) - 1)]
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        _LAST_TRIALS.append(time.perf_counter() - t0)
    return min(_LAST_TRIALS)


def _hps(hours: float, best_s: float) -> float:
    """Seconds → audio-h/s, and _LAST_TRIALS rewritten in the same unit."""
    _LAST_TRIALS[:] = [hours / t for t in _LAST_TRIALS]
    return hours / best_s


def _normal_inputs(seed: int, shape, n: int = 3):
    import jax
    import jax.numpy as jnp

    gen = jax.jit(lambda k: jax.random.normal(k, shape, jnp.float32))
    return [gen(k) for k in jax.random.split(jax.random.PRNGKey(seed), n)]


def _cfg():
    from modulation_mfcc.models.config import MfccConfig

    return MfccConfig(signal_sample_rate=SR, maxFreq=8000.0)


def _throughput(spectrum: str, batch: int = BATCH, seconds: float = SECONDS) -> float:
    import jax

    from modulation_mfcc.models.modulation import mfcc_change

    cfg = _cfg()
    xs = _normal_inputs(0, (batch, int(seconds * SR)))
    fn = jax.jit(lambda x: mfcc_change(x, cfg, spectrum=spectrum))
    return _hps(batch * seconds / 3600.0, _time_warm(fn, xs))


def _rows_throughput(spectrum: str, batch: int = BATCH, seconds: float = SECONDS) -> float:
    """Throughput from audio at rest in the hop-rows contract
    (ops/framing.pack_hop_rows): int16 PCM rows, dequantized on device."""
    import jax
    import jax.numpy as jnp

    from modulation_mfcc.models.modulation import mfcc_change
    from modulation_mfcc.ops.framing import pack_hop_rows

    cfg = _cfg()
    t = int(seconds * SR)

    @jax.jit
    def to_rows(x):
        pcm = jnp.clip(x * 8000.0, -32768, 32767).astype(jnp.int16)
        return pack_hop_rows(pcm, n_fft=cfg.n_fft, hop=cfg.hop_length)

    xs = [to_rows(x) for x in _normal_inputs(0, (batch, t))]
    fn = jax.jit(lambda r: mfcc_change(r, cfg, spectrum=spectrum, n_samples=t))
    return _hps(batch * seconds / 3600.0, _time_warm(fn, xs))


def _tracker_throughput(batch: int = 16, seconds: float = SECONDS) -> float:
    """Praat-class tracker sweep (f0 ac + formants + RMS envelope +
    intensity) in one jitted program, at 10 kHz."""
    import jax
    import jax.numpy as jnp

    from modulation_mfcc.models.envelope import rms_envelope
    from modulation_mfcc.ops.intensity import intensity_db
    from modulation_mfcc.ops.lpc import lpc_formants
    from modulation_mfcc.ops.pitch import pitch_ac

    sr = 10_000

    def one(y):
        f0 = pitch_ac(y, sr=float(sr))
        fr, _ = lpc_formants(y, sr=float(sr))
        env = rms_envelope(y, 250, 50)
        idb = intensity_db(y, sr=float(sr))
        return jnp.sum(f0) + jnp.nansum(fr) + jnp.sum(env) + jnp.sum(idb)

    xs = _normal_inputs(1, (batch, int(seconds * sr)))
    fn = jax.jit(lambda xb: jax.vmap(one)(xb))
    return _hps(batch * seconds / 3600.0, _time_warm(fn, xs))


def _pyin_throughput(batch: int = 8, seconds: float = SECONDS, sr: int = 10_000) -> float:
    """Probabilistic-YIN sweep (librosa.pyin parity path)."""
    import jax

    from modulation_mfcc.ops.yin import pyin_f0

    xs = _normal_inputs(2, (batch, int(seconds * sr)))
    fn = jax.jit(jax.vmap(lambda y: pyin_f0(y, sr=float(sr))))
    return _hps(batch * seconds / 3600.0, _time_warm(fn, xs))


def _modspec_throughput(batch: int = BATCH, seconds: float = SECONDS) -> float:
    """BASELINE config #3: modulation power spectrum over the MFCC
    trajectories, bf16 front-end."""
    import jax

    from modulation_mfcc.models.modulation import modulation_spectrum

    cfg = _cfg()
    xs = _normal_inputs(6, (batch, int(seconds * SR)))
    fn = jax.jit(lambda x: modulation_spectrum(x, cfg, spectrum="matmul_bf16"))
    return _hps(batch * seconds / 3600.0, _time_warm(fn, xs))


def _masked_batch_throughput() -> float:
    """BASELINE config #2: 64 variable-length utterances (8-30 s), padded
    and masked (exact per-file edges via the FIR operator), bf16 tier —
    real audio-h/s (padding excluded from the numerator)."""
    import jax
    import jax.numpy as jnp

    from modulation_mfcc.parallel.batch import AudioBatch, batched_mfcc_change

    cfg = _cfg()
    lengths = np.random.default_rng(3).integers(8 * SR, 30 * SR, size=64)
    lj = jnp.asarray(lengths.astype(np.int32))
    xs = _normal_inputs(4, (64, 30 * SR))
    fn = jax.jit(lambda xb: batched_mfcc_change(
        AudioBatch(xb, lj), cfg, spectrum="matmul_bf16", masked_fir=True)[0])
    return _hps(float(lengths.sum()) / SR / 3600.0, _time_warm(fn, xs))


def _longform_1h_seconds() -> float:
    """BASELINE config #4: one 1-hour 48 kHz recording, resampled on device
    to 16 kHz and run through the chunked streaming path — wall seconds of
    the warm program on a distinct input."""
    import jax

    from modulation_mfcc.ops.resample import resample_device
    from modulation_mfcc.parallel.streaming import chunked_mfcc_change

    cfg = _cfg()
    xs = _normal_inputs(5, (3600 * 48_000,))
    fn = jax.jit(lambda y: chunked_mfcc_change(resample_device(y, 48_000.0, 16_000.0), cfg))
    return _time_warm(fn, xs, trials=3)


def _gen_corpus(root: str, n_files: int, seconds: float, sr: int) -> list:
    from modulation_mfcc.io.wav import write_wav

    rng = np.random.default_rng(0)
    paths = []
    for i in range(n_files):
        y = (0.3 * rng.standard_normal(int(seconds * sr))).astype(np.float32)
        p = f"{root}/utt_{i:04d}.wav"
        write_wav(p, y, sr)
        paths.append(p)
    return paths


def _corpus_throughput(n_files: int = 96, seconds: float = SECONDS) -> float:
    """End-to-end corpus sweep: WAV files on disk → native decode → host
    bucketing/prefetch → bf16 device extraction → per-file .npz records.
    Audio-hours per wall second, manifest→npz inclusive, warmed on one full
    batch first."""
    import shutil
    import tempfile

    from modulation_mfcc.parallel.corpus import CorpusSweep, sweep_mfcc_change

    root = tempfile.mkdtemp(prefix="modmfcc_bench_corpus_")
    try:
        paths = _gen_corpus(root, n_files, seconds, SR)

        def run(subset, tag):
            sweep = CorpusSweep(out_dir=f"{root}/out_{tag}", cfg=_cfg(),
                                batch_size=32, spectrum="matmul_bf16", resume=False)
            t0 = time.perf_counter()
            report = sweep_mfcc_change(subset, sweep)
            return time.perf_counter() - t0, report

        run(paths[: min(32, n_files)], "warm")
        wall, report = run(paths, "main")
        _LAST_CORPUS_STATS.clear()
        _LAST_CORPUS_STATS.update(report.get("stages", {}))
        _LAST_CORPUS_STATS["wall_s"] = round(wall, 3)
        return n_files * seconds / 3600.0 / wall
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _device_info() -> dict:
    """The GPU the bench runs on; SystemExit(2) when JAX finds none."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench.py measures GPUs only; JAX runs on {devs[0].platform}",
              file=sys.stderr)
        raise SystemExit(2)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# (field, function, args, wall-cost estimate in seconds for the budget)
FIELDS = [
    ("value", _throughput, ("matmul_bf16",), 0.0),
    ("matmul_bf16_rows", _rows_throughput, ("matmul_bf16",), 0.0),
    ("matmul", _throughput, ("matmul",), 0.0),
    ("matmul_x3", _throughput, ("matmul_x3",), 0.0),
    ("matmul_x3_rows", _rows_throughput, ("matmul_x3",), 0.0),
    ("matmul_i24", _throughput, ("matmul_i24",), 0.0),
    ("matmul_i24_rows", _rows_throughput, ("matmul_i24",), 0.0),
    ("matmul_i16", _throughput, ("matmul_i16",), 0.0),
    ("matmul_i16_rows", _rows_throughput, ("matmul_i16",), 0.0),
    ("fft", _throughput, ("fft",), 0.0),
    ("tracker_sweep", _tracker_throughput, (), 0.0),
    ("pyin_sweep", _pyin_throughput, (), 0.0),
    ("pyin_sweep_16k", _pyin_throughput, (8, SECONDS, 16_000), 0.0),
    ("masked_batch_64", _masked_batch_throughput, (), 0.0),
    ("modspec_batch", _modspec_throughput, (), 0.0),
    ("longform_1h_s", _longform_1h_seconds, (), 0.0),
    ("corpus_sweep", _corpus_throughput, (), 180.0),
]


def main() -> int:
    # the artifact is the LAST JSON line of stdout: keep the package's own
    # event records out of it
    os.environ["MODMFCC_LOG_SILENT"] = "1"
    device = _device_info()
    t_start = time.monotonic()
    budget = float(os.environ.get("MODMFCC_BENCH_TOTAL_TIMEOUT", "2400"))
    fields: dict = {name: None for name, *_ in FIELDS}
    repeat_stats: dict = {}
    failed: list = []
    skipped_wall: list = []

    def emit(partial: bool) -> None:
        art = {
            "metric": "mfcc_modulation_throughput",
            "value": fields["value"],
            "unit": "audio-hours/sec/card @16kHz (matmul_bf16)",
            "device": device,
            **{k: v for k, v in fields.items() if k != "value"},
            "bench_wall_s": round(time.monotonic() - t_start, 1),
        }
        if _LAST_CORPUS_STATS:
            art["corpus_stats"] = dict(_LAST_CORPUS_STATS)
        for key, val in (("repeat_stats", repeat_stats), ("failed", failed),
                         ("skipped_wall", skipped_wall)):
            if val:
                art[key] = val
        if partial:
            art["partial"] = True
        print(json.dumps(art), flush=True)

    for name, fn, args, cost_s in FIELDS:
        if budget - (time.monotonic() - t_start) < cost_s:
            skipped_wall.append(name)
            continue
        _LAST_TRIALS.clear()
        try:
            fields[name] = round(fn(*args), 3)
        except Exception as e:  # noqa: BLE001 — reported, and the exit says so
            print(f"# {name} failed: {e!r}", file=sys.stderr)
            failed.append(name)
            continue
        if _LAST_TRIALS:
            ts = sorted(round(t, 3) for t in _LAST_TRIALS)
            repeat_stats[name] = [ts[0], ts[len(ts) // 2], ts[-1]]
        emit(partial=True)
    emit(partial=False)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
