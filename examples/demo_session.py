"""End-to-end analysis session demo — the reference GUI workflow as a script.

Run: python examples/demo_session.py /path/to/utterance.wav
(With no argument, synthesizes a demo utterance.)
"""
import sys

import numpy as np

from modulation_mfcc.io.wav import write_wav
from modulation_mfcc.models.workbench import AnalysisSession


def main() -> None:
    if len(sys.argv) > 1:
        wav = sys.argv[1]
    else:
        sr = 10_000
        t = np.arange(int(2.0 * sr)) / sr
        f0 = 120 + 25 * np.sin(2 * np.pi * 1.5 * t)
        ph = 2 * np.pi * np.cumsum(f0) / sr
        y = sum((0.6 / k) * np.sin(k * ph) for k in range(1, 5))
        y *= 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)
        wav = "/tmp/demo_utt.wav"
        write_wav(wav, y, sr)

    s = AnalysisSession(wav)
    s.add_curve("mod_cepstr", panel=0)
    s.add_curve("envelope", panel=0)
    s.add_curve("f0", panel=1)
    s.add_curve("mod_cepstr", panel=1, derivation=1, name="mod_vel")
    dur = float(s.sound.timestamps[-1])
    s.set_region(0.1 * dur, 0.9 * dur)
    peaks = s.analyze_max_peaks(panel=0)
    print({k: len(v[0]) for k, v in peaks.items()}, "maxima in region")
    s.export_csv("/tmp/demo_session.csv")
    s.render(out="/tmp/demo_session.png")
    print("wrote /tmp/demo_session.csv and /tmp/demo_session.png")


if __name__ == "__main__":
    main()
