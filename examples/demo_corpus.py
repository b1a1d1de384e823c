"""Corpus sweep demo: synthesize a small corpus, extract everything, resume.

Run: python examples/demo_corpus.py [out_dir]
"""
import os
import sys

import numpy as np

from modulation_mfcc.io.wav import write_wav
from modulation_mfcc.parallel.corpus import CorpusSweep, sweep_mfcc_change


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/demo_feats"
    wav_dir = "/tmp/demo_corpus"
    os.makedirs(wav_dir, exist_ok=True)
    sr = 10_000
    rng = np.random.default_rng(0)
    paths = []
    for i in range(8):
        dur = 0.8 + 0.25 * (i % 3)
        t = np.arange(int(dur * sr)) / sr
        y = 0.6 * np.sin(2 * np.pi * (110 + 12 * i) * t)
        y *= 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)
        y += 0.01 * rng.standard_normal(len(t))
        p = os.path.join(wav_dir, f"utt{i:02d}.wav")
        write_wav(p, y, sr)
        paths.append(p)

    sweep = CorpusSweep(
        out_dir=out,
        batch_size=4,
        features=("mod_cepstr", "f0", "envelope", "mfcc39", "formants"),
    )
    report = sweep_mfcc_change(paths, sweep)
    print("throughput report:", report)
    rec = np.load(os.path.join(out, "utt00.npz"))
    print("record keys:", sorted(rec.keys()))
    print("mfcc39 shape:", rec["mfcc39"].shape)


if __name__ == "__main__":
    main()
