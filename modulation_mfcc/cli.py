"""Command-line interface: extract / bench / verify / info.

The reference has no CLI (its entry point is a Qt window, script/main.py:2157);
this is the batch-first replacement: point it at WAVs (or a manifest), get
feature tables out.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="modmfcc", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    ex = sub.add_parser("extract", help="extract features from WAV file(s)")
    ex.add_argument("inputs", nargs="+", help="WAV files")
    ex.add_argument("--config", help="reference-schema JSON config file")
    ex.add_argument(
        "--features",
        default="mod_cepstr",
        help="comma list: mod_cepstr,f0,formants,envelope,mfcc",
    )
    ex.add_argument("--out", default="-", help="output CSV path or - for stdout")
    ex.add_argument("--derivation", type=int, default=0, choices=(0, 1, 2),
                    help="0 trajectory, 1 velocity, 2 acceleration")

    sub.add_parser("bench", help="run the headline throughput benchmark")

    ver = sub.add_parser("verify", help="parity harness vs the CPU oracle")
    ver.add_argument("--wav", help="optional WAV to verify on (default: synthetic)")
    ver.add_argument("--seconds", type=float, default=2.0,
                     help="synthetic signal length (ignored with --wav)")
    ver.add_argument("--sr", type=int, default=10_000,
                     help="analysis sample rate for every surface "
                          "(default: the reference's 10000; the bench "
                          "flagship runs 16000)")

    sub.add_parser("info", help="print device/mesh info")

    sw = sub.add_parser("sweep", help="corpus sweep: many WAVs → npz feature store")
    sw.add_argument("inputs", nargs="+", help="WAV files or directories")
    sw.add_argument("--out", required=True, help="output directory")
    sw.add_argument("--config", help="reference-schema JSON config file")
    sw.add_argument("--batch-size", type=int, default=32)
    sw.add_argument("--spectrum", default="auto",
                    help="auto (= matmul), fft, matmul, matmul_x3, "
                         "matmul_bf16, matmul_i24 or matmul_i16")
    sw.add_argument("--features", default="mod_cepstr",
                    help="comma list: mod_cepstr, mfcc39, f0, envelope, formants")
    sw.add_argument("--no-resume", action="store_true")
    sw.add_argument("--num-shards", type=int, default=1,
                    help="multi-process scale-out, one process per card (or "
                         "per host): total manifest shards")
    sw.add_argument("--shard-id", type=int, default=0,
                    help="this process's shard index (0-based)")

    pv = sub.add_parser("plot", help="render an analysis figure for a WAV")
    pv.add_argument("wav")
    pv.add_argument("--out", required=True, help="output PNG path")
    pv.add_argument("--features", default="mod_cepstr,envelope,f0",
                    help="comma list of curves")
    pv.add_argument("--textgrid", help="optional TextGrid overlay")
    pv.add_argument("--config", help="reference-schema JSON config file")
    pv.add_argument("--region", nargs=2, type=float, metavar=("START", "END"),
                    help="selection region; peaks are analyzed inside it")

    args = p.parse_args(argv)

    if args.cmd == "info":
        import jax

        print(json.dumps({
            "backend": jax.default_backend(),
            "devices": [str(d) for d in jax.devices()],
            "version": _version(),
        }))
        return 0
    if args.cmd == "bench":
        import pathlib
        import runpy

        bench = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
        runpy.run_path(str(bench), run_name="__main__")
        return 0
    if args.cmd == "extract":
        from modulation_mfcc.runner import run_extract

        return run_extract(args)
    if args.cmd == "verify":
        from modulation_mfcc.runner import run_verify

        return run_verify(args)
    if args.cmd == "sweep":
        from modulation_mfcc.runner import run_sweep

        return run_sweep(args)
    if args.cmd == "plot":
        from modulation_mfcc.runner import run_plot

        return run_plot(args)
    return 2


def _version() -> str:
    from modulation_mfcc import __version__

    return __version__


if __name__ == "__main__":
    sys.exit(main())
