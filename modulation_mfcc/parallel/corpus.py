"""Corpus-scale extraction driver: manifest in, feature store out.

The scale layer the reference lacks entirely (it processes one file per GUI
interaction, SURVEY.md §2e). Design:

  * manifest = list of WAV paths (file, or directory glob);
  * files are decoded + resampled host-side (background thread), bucketed by
    length (static shapes → one compiled program per bucket), padded, and
    streamed to the device with double-buffered prefetch;
  * extraction is the batched masked modulation pipeline (optionally
    mesh-sharded over the 'data' axis);
  * results land in per-file ``.npz`` records (times + features), with a
    done-manifest for resumable sweeps (crash → rerun skips finished files);
  * per-file error isolation: a corrupt WAV is logged and skipped, never
    aborts the sweep (SURVEY.md §5 failure handling).
"""
from __future__ import annotations

import os
from collections import deque
from dataclasses import dataclass

import numpy as np

from functools import partial

import jax
import jax.numpy as jnp

from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.models.modulation import change_times, min_frames_for_fir
from modulation_mfcc.ops.spectral import check_spectrum
from modulation_mfcc.parallel.batch import AudioBatch, batched_mfcc_change
from modulation_mfcc.parallel.prefetch import background_iter, prefetch_to_device
from modulation_mfcc.utils.obs import ThroughputMeter, log_event

__all__ = ["CorpusSweep", "sweep_mfcc_change"]


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "spectrum", "features", "f0cfg", "acfg", "fmcfg", "mesh",
    ),
)
def _extras_impl(samples, lengths, cfg, spectrum, features, f0cfg, acfg, fmcfg,
                 mesh):
    """All requested extra feature tracks in ONE compiled program.

    One execution + one host fetch per batch instead of one round trip per
    feature, and XLA can overlap the feature subgraphs."""
    from modulation_mfcc.models.features import mfcc_with_deltas
    from modulation_mfcc.models.modulation import mfcc_trajectories
    from modulation_mfcc.parallel.batch import frame_validity_mask
    from modulation_mfcc.parallel.features_batch import (
        batched_envelope,
        batched_f0,
    )

    if mesh is not None:
        # same GSPMD pattern as parallel/batch._sharded_impl: annotate the
        # batch axis over 'data' and let XLA shard every tracker with it
        from jax.sharding import NamedSharding, PartitionSpec as P

        samples = jax.lax.with_sharding_constraint(
            samples, NamedSharding(mesh, P("data", None))
        )
        lengths = jax.lax.with_sharding_constraint(
            lengths, NamedSharding(mesh, P("data"))
        )
    from modulation_mfcc.parallel.batch import dequantize_samples

    samples = dequantize_samples(samples)  # int16 corpus buckets → f32
    out = {}
    ab = AudioBatch(samples, lengths)
    if "mfcc39" in features:
        mask = frame_validity_mask(lengths, samples.shape[-1], cfg)
        m = mfcc_trajectories(samples, cfg, frame_mask=mask, spectrum=spectrum)
        out["mfcc39"] = (mfcc_with_deltas(m, frame_mask=mask, normalize=True), mask)
    if "f0" in features:
        out["f0"] = batched_f0(ab, float(cfg.signal_sample_rate), f0cfg)
    if "envelope" in features:
        out["envelope"] = batched_envelope(ab, float(cfg.signal_sample_rate), acfg)
    if "formants" in features:
        # Praat's first formant step resamples to 2× the formant ceiling
        # (script/calc.py:131-141); here the rate change happens ON DEVICE
        # (polyphase-as-strided-conv, ops/resample.py) so the 11 kHz stream
        # never exists host-side.
        from fractions import Fraction

        from modulation_mfcc.ops.lpc import formant_frames
        from modulation_mfcc.ops.resample import n_resampled, resample_poly_device
        from modulation_mfcc.parallel.features_batch import batched_formants

        sr0 = float(cfg.signal_sample_rate)
        frac = Fraction(
            int(round(2.0 * fmcfg.max_formant)), int(round(sr0))
        ).limit_denominator(1000)
        up, dn = frac.numerator, frac.denominator
        xr = resample_poly_device(samples, up, dn)
        sr2 = sr0 * up / dn
        fr, bw = batched_formants(xr, sr2, fmcfg)
        starts, nw, _ = formant_frames(
            xr.shape[-1], sr2, fmcfg.window_length, fmcfg.time_step
        )
        len2 = n_resampled(lengths, up, dn)  # works elementwise on the array
        fvalid = jnp.asarray(starts + nw)[None, :] <= len2[:, None]
        out["formants"] = (fr, fvalid)
        out["formant_bw"] = (bw, fvalid)
    return out


@dataclass
class CorpusSweep:
    """Configuration of one corpus run."""

    out_dir: str
    cfg: MfccConfig = MfccConfig()
    batch_size: int = 32
    bucket_multiple: int = 16_384
    # 'matmul_i16' is the natural PARITY sweep: corpus audio reaches the
    # device as int16 (the upload format), exactly the i16 tier's
    # exactness domain — ≤1e-4 MFCC parity in fixed point.
    # 'matmul_bf16' is the throughput mode (BASELINE config #5).
    # 'auto' (default) = 'matmul' (float32 HIGHEST).
    spectrum: str = "auto"
    resume: bool = True
    use_native_loader: bool = True  # C++ threaded decode+resample when built
    loader_threads: int = 4
    features: tuple = ("mod_cepstr",)  # mod_cepstr, mfcc39, f0, envelope, formants
    f0_cfg: object = None  # F0Config | None
    amp_cfg: object = None  # AmplitudeConfig | None
    formant_cfg: object = None  # FormantConfig | None
    mesh: object = None  # jax.sharding.Mesh | None: data-parallel over 'data'


def _done_path(sweep: CorpusSweep) -> str:
    return os.path.join(sweep.out_dir, "_done.txt")


def _output_names(paths: list[str]) -> dict[str, str]:
    """Collision-free npz name per input path. Plain basenames when unique;
    duplicate stems (same filename in different directories) get a short
    path hash so distinct inputs never overwrite each other's records."""
    import hashlib

    stems: dict[str, int] = {}
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        stems[stem] = stems.get(stem, 0) + 1
    names = {}
    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0]
        if stems[stem] > 1:
            stem += "_" + hashlib.sha1(p.encode()).hexdigest()[:8]
        names[p] = stem + ".npz"
    return names


def _load_done(sweep: CorpusSweep) -> set[str]:
    try:
        with open(_done_path(sweep)) as f:
            return {line.strip() for line in f if line.strip()}
    except FileNotFoundError:
        return set()


def _decode_stream(paths, sweep: CorpusSweep):
    """Host stage: decode/resample each file; yield (path, samples) or log+skip.

    Uses the native multithreaded loader (native/modmfcc_io.cpp) when built;
    falls back to the Python reader per file otherwise.
    """
    if sweep.use_native_loader:
        try:
            from modulation_mfcc.io.native import NativeBatchLoader, native_available

            if native_available():
                yield from _decode_stream_native(paths, sweep)
                return
        except Exception as e:
            log_event("corpus.native_loader_unavailable", error=str(e))
    from modulation_mfcc.io.wav import load_channel

    for p in paths:
        try:
            y = load_channel(p, sweep.cfg.signal_sample_rate)
            if y.ndim > 1:
                y = y[0]
            if len(y) < sweep.cfg.n_fft:
                raise ValueError(f"too short ({len(y)} samples)")
            yield p, np.asarray(y, dtype=np.float32)
        except Exception as e:
            log_event("corpus.skip", file=p, error=f"{type(e).__name__}: {e}")


def _decode_stream_native(paths, sweep: CorpusSweep):
    from modulation_mfcc.io.native import NativeBatchLoader

    # int16 passthrough: 16-bit PCM at the target rate never becomes f32 on
    # the host — decode, pad and upload all stay on the int16 grid (half the
    # link bytes AND none of the ×2¹⁵/min-max/astype/array_equal passes the
    # f32 grid-check needs; measured the single biggest host cost at corpus
    # scale). Device side dequantizes exactly
    # (parallel/batch.dequantize_samples), same as the grid-check path.
    loader = NativeBatchLoader(
        int(sweep.cfg.signal_sample_rate), n_threads=sweep.loader_threads,
        want_i16=True,
    )
    try:
        for i, p in enumerate(paths):
            loader.submit(i, p)
        for idx, samples in loader:
            p = paths[idx]
            if samples is None or len(samples) < sweep.cfg.n_fft:
                log_event("corpus.skip", file=p, error="native decode failed or too short")
                continue
            yield p, samples
    finally:
        loader.close()


def _timed_iter(gen, stats: dict, key: str):
    """Accumulate the time the wrapped generator spends PRODUCING each item
    (stage busy time as seen by its consumer thread) into ``stats[key]``."""
    import time

    it = iter(gen)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        stats[key] += time.perf_counter() - t0
        yield item


def _bucketed_batches(items, sweep: CorpusSweep, stats: dict | None = None,
                      rows_mode: bool = False):
    """Group decoded files into fixed-size padded batches by length bucket."""
    import time

    buckets: dict[tuple, list] = {}
    for path, y in items:
        from modulation_mfcc.utils.helpers import round_up_to_multiple

        # dtype is part of the bucket key: int16-passthrough files and
        # float32 files (resampled / float-source) never share a batch, so
        # each batch uploads in its own format
        key = (
            round_up_to_multiple(len(y), sweep.bucket_multiple),
            y.dtype == np.int16,
        )
        buckets.setdefault(key, []).append((path, y))
        if len(buckets[key]) == sweep.batch_size:
            group = buckets.pop(key)
            t0 = time.perf_counter()
            b = _make_batch(group, key[0], sweep.cfg if rows_mode else None)
            if stats is not None:
                stats["assemble_busy_s"] += time.perf_counter() - t0
            yield b
    for key, group in buckets.items():
        t0 = time.perf_counter()
        b = _make_batch(group, key[0], sweep.cfg if rows_mode else None)
        if stats is not None:
            stats["assemble_busy_s"] += time.perf_counter() - t0
        yield b


def _make_batch(group, t_pad, rows_cfg: MfccConfig | None = None):
    paths = [p for p, _ in group]
    sigs = [y for _, y in group]
    lengths = np.array([len(s) for s in sigs], dtype=np.int32)
    if rows_cfg is not None and all(s.dtype == np.int16 for s in sigs):
        # hop-rows assembly (the at-rest contract, ops/framing.
        # pack_hop_rows): the SAME one pad-memcpy per file the flat path
        # does, placed at the centered-framing offset in a hop-row-shaped
        # buffer — the device then only reshapes it, no pad pass
        from modulation_mfcc.ops.framing import hop_rows_geometry

        hop = rows_cfg.hop_length
        rows_total, offset = hop_rows_geometry(t_pad, n_fft=rows_cfg.n_fft, hop=hop)
        buf = np.zeros((len(sigs), rows_total * hop), np.int16)
        for i, s in enumerate(sigs):
            buf[i, offset : offset + len(s)] = s
        samples = buf.reshape(len(sigs), rows_total, hop)
        return paths, {"samples": samples, "lengths": lengths}, t_pad
    if all(s.dtype == np.int16 for s in sigs):
        # int16 passthrough (native loader want_i16): already on the upload
        # grid — one pad memcpy, no float conversion, no grid check
        samples = np.zeros((len(sigs), t_pad), dtype=np.int16)
        for i, s in enumerate(sigs):
            samples[i, : len(s)] = s
        return paths, {"samples": samples, "lengths": lengths}, None
    samples = np.zeros((len(sigs), t_pad), dtype=np.float32)
    for i, s in enumerate(sigs):
        samples[i, : len(s)] = s
    # 16-bit-exact buckets (decoded straight from 16-bit PCM with no
    # resampling) ship as int16 — half the host→device bytes on the
    # bandwidth-limited link, dequantized EXACTLY on device
    # (parallel/batch.dequantize_samples). Off-grid values (resampled or
    # float-source files) keep the float32 path. The range pre-check keeps
    # NaN/out-of-range samples (hot-mastered or bad decodes) away from the
    # implementation-defined float→int cast; within range, the cast IS the
    # grid check (i16 round-trips to the scaled value iff on-grid).
    scaled = samples * np.float32(2.0**15)
    # truncation is well-defined exactly on [-32768, 32768); NaN fails
    # both comparisons and keeps the float path
    if scaled.min() >= -32768.0 and scaled.max() < 32768.0:
        as_i16 = scaled.astype(np.int16)
        if np.array_equal(as_i16, scaled):
            samples = as_i16
    return paths, {"samples": samples, "lengths": lengths}, None


def sweep_mfcc_change(paths: list[str], sweep: CorpusSweep) -> dict:
    """Run the sweep; returns the throughput report.

    Output: ``<out_dir>/<basename>.npz`` (duplicate basenames get a short
    path-hash suffix) with keys ``times`` and ``mod_cepstr`` per input file,
    plus ``_done.txt`` for resume.
    """
    os.makedirs(sweep.out_dir, exist_ok=True)
    if sweep.spectrum == "auto":
        from dataclasses import replace as _dc_replace

        sweep = _dc_replace(sweep, spectrum="matmul")
    check_spectrum(sweep.spectrum)
    out_names = _output_names(paths)
    done = _load_done(sweep) if sweep.resume else set()
    todo = [p for p in paths if p not in done]
    log_event("corpus.start", files=len(paths), todo=len(todo), resumed=len(paths) - len(todo))

    meter = ThroughputMeter()
    # per-stage busy-time accounting (r3 verdict #3: the end-to-end number
    # was opaque — a ~900× gap between chip rate and corpus rate with no
    # evidence of where it went). Each stage accumulates the time it spends
    # *producing* items as seen from its own thread; the stages overlap
    # (background threads + async dispatch), so the fields explain the wall
    # without summing to it. Reported in corpus.finish and the bench
    # artifact ("corpus_stats").
    stats = {
        "decode_busy_s": 0.0, "assemble_busy_s": 0.0, "upload_busy_s": 0.0,
        "upload_mb": 0.0, "fetch_wait_s": 0.0, "write_busy_s": 0.0,
    }
    # hop-rows path (ops/framing.pack_hop_rows): int16 batches assemble
    # with the centered-framing pad already in place. Only when mod_cepstr
    # is the sole feature: the tracker extras consume flat samples. f32
    # (off-grid) buckets fall back to flat automatically (_make_batch keys
    # assembly on the bucket's dtype).
    rows_mode = (
        sweep.spectrum.startswith("matmul")
        and tuple(sweep.features) == ("mod_cepstr",)
        and sweep.mesh is None
    )
    decode = background_iter(
        _timed_iter(_decode_stream(todo, sweep), stats, "decode_busy_s"),
        maxsize=2 * sweep.batch_size,
    )
    # batch assembly (pad copy + int16-grid check) is itself ~0.3 s/GB of
    # host passes — run it in a worker thread too so it overlaps the main
    # loop's device dispatch/fetch (numpy releases the GIL)
    batches = background_iter(
        _bucketed_batches(decode, sweep, stats, rows_mode=rows_mode), maxsize=2
    )

    # (paths, host-side lengths, rows-batch n_samples) per batch: lengths
    # are host-known before upload, so the write-out loop never reads them
    # back from the device
    path_groups: list[tuple[list[str], np.ndarray, int | None]] = []

    def device_stream():
        for paths_b, arrays, t_pad_b in batches:
            path_groups.append((paths_b, arrays["lengths"], t_pad_b))
            yield arrays

    mf = min_frames_for_fir(sweep.cfg)

    @partial(jax.jit, static_argnames=("masked_fir", "n_samples"))
    def run_batch(samples, lengths, masked_fir, n_samples=None):
        return batched_mfcc_change(
            AudioBatch(samples, lengths), sweep.cfg,
            spectrum=sweep.spectrum, masked_fir=masked_fir,
            n_samples=n_samples,
        )

    def run_mod(samples_d, lengths_d, fir_ok, t_pad_b=None):
        if sweep.mesh is not None:
            from modulation_mfcc.parallel.batch import sharded_mfcc_change

            tot, mask, _mean = sharded_mfcc_change(
                AudioBatch(samples_d, lengths_d), sweep.cfg, sweep.mesh,
                spectrum=sweep.spectrum, masked_fir=fir_ok,
            )
            return tot, mask
        return run_batch(samples_d, lengths_d, fir_ok, t_pad_b)

    from modulation_mfcc.models.config import (
        AmplitudeConfig,
        F0Config,
        FormantConfig,
    )

    f0cfg = sweep.f0_cfg or F0Config()
    acfg = sweep.amp_cfg or AmplitudeConfig()
    fmcfg = sweep.formant_cfg or FormantConfig()
    env_per_file = "envelope" in sweep.features and acfg.method == "RMSpraat"
    jit_feats = tuple(
        f
        for f in ("mfcc39", "f0", "envelope", "formants")
        if f in sweep.features and not (f == "envelope" and env_per_file)
    )

    def dispatch_extras(samples_d, lengths_d):
        """Dispatch the fused extras program (one compiled program per
        bucket, see _extras_impl) WITHOUT blocking — the pytree of device
        arrays is fetched later in the same device_get as the headline
        result, so each batch costs one host round trip total."""
        if not jit_feats:
            return None
        return _extras_impl(
            samples_d, lengths_d, sweep.cfg, sweep.spectrum,
            jit_feats, f0cfg, acfg, fmcfg, sweep.mesh,
        )

    def assemble_extras(host, samples_d, lengths_d):
        """Format the fetched extras + run the (rare, host-synchronous)
        per-file RMSpraat path."""
        out = {}
        if host is not None:
            if "mfcc39" in host:
                out["mfcc39"] = (*host["mfcc39"], sweep.cfg.tStep)
            if "f0" in host:
                out["f0"] = (*host["f0"], f0cfg.hopSize)
            if "envelope" in host:
                out["envelope"] = (*host["envelope"], acfg.hopLen)
            if "formants" in host:
                out["formants"] = (*host["formants"], fmcfg.time_step)
                out["formant_bw"] = (*host["formant_bw"], fmcfg.time_step)
        if env_per_file:
            # RMSpraat is pitch-adaptive: output rate is chosen per file,
            # so it runs the per-file path (one compile per distinct
            # length — fine for uniform corpora, logged for ragged ones)
            from modulation_mfcc.models.envelope import extract_envelope

            sr = float(sweep.cfg.signal_sample_rate)
            log_event("corpus.envelope_per_file", method=acfg.method)
            from modulation_mfcc.parallel.batch import dequantize_samples

            s_np = np.asarray(dequantize_samples(np.asarray(samples_d)))
            l_np = np.asarray(lengths_d)
            pairs = [
                extract_envelope(s_np[i, : l_np[i]], sr, acfg)
                for i in range(len(l_np))
            ]
            width = max(a.shape[-1] for a, _ in pairs)
            vals = np.zeros((len(pairs), width), dtype=np.float32)
            valid = np.zeros((len(pairs), width), dtype=bool)
            hops = np.empty(len(pairs))
            for i, (a, tgrid) in enumerate(pairs):
                a = np.asarray(a)
                vals[i, : len(a)] = a
                valid[i, : len(a)] = True
                hops[i] = tgrid[1] - tgrid[0] if len(tgrid) > 1 else acfg.hopLen
            out["envelope"] = (vals, valid, hops)
        return out

    # Software pipeline over batches: the loop dispatches batch k+1's
    # programs BEFORE blocking on batch k's results, so device compute
    # overlaps both the host npz writes and the result readback.
    # Everything a batch produces comes back in ONE jax.device_get:
    # lengths are host-known before upload and the frame mask is a
    # closed-form function of them (frame_validity_mask: nf = 1 + len//hop).
    pending: deque = deque()

    import time as _time

    def flush_one(done_f):
        paths_b, lengths_np, tot_d, extras_d, samples_d, lengths_d = pending.popleft()
        t0 = _time.perf_counter()
        tot, extras_host = jax.device_get((tot_d, extras_d))
        stats["fetch_wait_s"] += _time.perf_counter() - t0
        extras = assemble_extras(extras_host, samples_d, lengths_d)
        t0 = _time.perf_counter()
        for i, p in enumerate(paths_b):
            n_i = int(lengths_np[i])
            nf = min(1 + n_i // sweep.cfg.hop_length, tot.shape[-1])
            times = change_times(n_i, sweep.cfg)[:nf]
            out = os.path.join(sweep.out_dir, out_names[p])
            rec = {"times": times, "mod_cepstr": tot[i, :nf]}
            for name, (vals, valid, hop) in extras.items():
                nvf = int(valid[i].sum())
                hop_i = float(hop[i]) if isinstance(hop, np.ndarray) else hop
                rec[name] = vals[i, :nvf]
                rec[name + "_times"] = np.arange(nvf) * hop_i
            np.savez(out, **rec)
            done_f.write(p + "\n")
            meter.add(n_i / sweep.cfg.signal_sample_rate)
        done_f.flush()
        stats["write_busy_s"] += _time.perf_counter() - t0

    with open(_done_path(sweep), "a") as done_f:
        for arrays in prefetch_to_device(
            device_stream(), depth=2, stats=stats, mesh=sweep.mesh
        ):
            paths_b, lengths_np, t_pad_b = path_groups.pop(0)
            nf_min = 1 + int(lengths_np.min()) // sweep.cfg.hop_length
            fir_ok = mf is not None and nf_min >= mf
            tot, _mask = run_mod(
                arrays["samples"], arrays["lengths"], fir_ok, t_pad_b
            )
            extras_d = dispatch_extras(arrays["samples"], arrays["lengths"])
            pending.append(
                (
                    paths_b,
                    lengths_np,
                    tot,
                    extras_d,
                    # device samples stay referenced only when the per-file
                    # RMSpraat assembly will need them on the host
                    arrays["samples"] if env_per_file else None,
                    arrays["lengths"] if env_per_file else None,
                )
            )
            if len(pending) >= 2:
                flush_one(done_f)
        while pending:
            flush_one(done_f)
    report = meter.report()
    report["stages"] = {k: round(v, 4) for k, v in stats.items()}
    if stats["upload_busy_s"] > 0:
        report["stages"]["link_mbps"] = round(
            stats["upload_mb"] / stats["upload_busy_s"], 1
        )
    log_event("corpus.finish", **report)
    return report
