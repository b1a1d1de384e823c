"""ctypes binding for the native host IO runtime (native/modmfcc_io.cpp).

Auto-builds ``libmodmfcc_io.so`` with make on first use (g++ toolchain) and
falls back transparently to the pure-Python io/wav.py path when unavailable
— the native loader is a throughput optimization, never a hard dependency.

The polyphase taps are designed host-side with scipy (same design
resample_poly uses: kaiser-5.0 firwin at the conservative cutoff), so the
native resampler is numerically testable against scipy.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

__all__ = ["native_available", "decode_wav_native", "NativeBatchLoader", "design_resample_taps"]

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_SO = os.path.join(_NATIVE_DIR, "libmodmfcc_io.so")


@lru_cache(maxsize=1)
def _lib():
    # Run make unconditionally (mtime check makes it a cheap no-op when
    # fresh): an .so built before an ABI addition (e.g. the v2 int16
    # entry points) would otherwise never rebuild, silently disabling the
    # newer fast paths on any host that built the lib once.
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR], check=True,
            capture_output=True, timeout=120,
        )
    except Exception:
        if not os.path.exists(_SO):
            return None
        # a previously-built lib is still usable when make itself fails
        # (e.g. read-only checkout without a toolchain)
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    lib.modmfcc_decode_wav.restype = ctypes.c_long
    lib.modmfcc_decode_wav.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.modmfcc_resample.restype = ctypes.c_long
    lib.modmfcc_resample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
    ]
    lib.modmfcc_free.argtypes = [ctypes.c_void_p]
    lib.modmfcc_loader_create.restype = ctypes.c_void_p
    lib.modmfcc_loader_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.modmfcc_loader_add_taps.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
    ]
    lib.modmfcc_loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
    lib.modmfcc_loader_next.restype = ctypes.c_int
    lib.modmfcc_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.modmfcc_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    return _lib() is not None


def design_resample_taps(up: int, down: int) -> np.ndarray:
    """The package's kaiser_best-grade polyphase filter (io/wav.py), WITHOUT
    the ``up`` gain (the native kernel applies it) — one shared design keeps
    the Python and native resampling paths numerically identical."""
    from modulation_mfcc.io.wav import design_hq_taps

    return design_hq_taps(up, down)


def decode_wav_native(path: str) -> tuple[np.ndarray, int]:
    """Native decode (first channel). Raises on failure."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    data = ctypes.POINTER(ctypes.c_float)()
    sr = ctypes.c_int()
    n = lib.modmfcc_decode_wav(path.encode(), ctypes.byref(data), ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"{path}: native WAV decode failed")
    out = np.ctypeslib.as_array(data, shape=(n,)).copy()
    lib.modmfcc_free(data)
    return out, sr.value


def resample_native(x: np.ndarray, up: int, down: int) -> np.ndarray:
    lib = _lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    taps = design_resample_taps(up, down)
    x32 = np.ascontiguousarray(x, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.modmfcc_resample(
        x32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x32), up, down,
        taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(taps),
        ctypes.byref(out),
    )
    y = np.ctypeslib.as_array(out, shape=(n,)).copy()
    lib.modmfcc_free(out)
    return y


class NativeBatchLoader:
    """Threaded decode+resample of many files; iterate (index, samples|None)."""

    COMMON_RATES = (8000, 11025, 16000, 22050, 32000, 44100, 48000, 96000)

    def __init__(self, target_sr: int, n_threads: int = 4, source_rates=None,
                 want_i16: bool = False):
        """``want_i16=True``: 16-bit PCM files that need no resampling come
        back as raw np.int16 (the corpus upload grid) instead of float32 —
        no conversion pass, and the consumer can skip its on-grid check.
        Requires the v2 native ABI (falls back to float32 on a stale .so)."""
        lib = _lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._i16 = bool(want_i16) and hasattr(lib, "modmfcc_loader_create2")
        if want_i16 and not self._i16:
            # observable, not silent: the int16 passthrough is the corpus
            # pipeline's biggest host-cost win — losing it to a stale ABI
            # must show up in the sweep's event log
            from ..utils.obs import log_event

            log_event("native.i16_fallback", reason="pre-v2 ABI .so")
        if self._i16:
            lib.modmfcc_loader_create2.restype = ctypes.c_void_p
            lib.modmfcc_loader_create2.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            lib.modmfcc_loader_next2.restype = ctypes.c_int
            lib.modmfcc_loader_next2.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int),
            ]
            self._h = lib.modmfcc_loader_create2(n_threads, target_sr, 1)
        else:
            self._h = lib.modmfcc_loader_create(n_threads, target_sr)
        self._submitted = 0
        self._taps_alive = []
        import math

        for orig in source_rates or self.COMMON_RATES:
            if orig == target_sr:
                continue
            g = math.gcd(int(orig), int(target_sr))
            up, down = target_sr // g, orig // g
            taps = design_resample_taps(up, down)
            self._taps_alive.append(taps)
            lib.modmfcc_loader_add_taps(
                self._h, up, down,
                taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(taps),
            )

    def submit(self, index: int, path: str):
        self._lib.modmfcc_loader_submit(self._h, index, path.encode())
        self._submitted += 1

    def __iter__(self):
        while True:
            if self._i16:
                vdata = ctypes.c_void_p()
                n = ctypes.c_long()
                fmt = ctypes.c_int()
                idx = self._lib.modmfcc_loader_next2(
                    self._h, ctypes.byref(vdata), ctypes.byref(n), ctypes.byref(fmt)
                )
                if idx < 0:
                    return
                if n.value < 0:
                    yield idx, None
                    continue
                ctyp = ctypes.c_int16 if fmt.value else ctypes.c_float
                ptr = ctypes.cast(vdata, ctypes.POINTER(ctyp))
                out = np.ctypeslib.as_array(ptr, shape=(n.value,)).copy()
                self._lib.modmfcc_free(vdata)
                yield idx, out
                continue
            data = ctypes.POINTER(ctypes.c_float)()
            n = ctypes.c_long()
            idx = self._lib.modmfcc_loader_next(self._h, ctypes.byref(data), ctypes.byref(n))
            if idx < 0:
                return
            if n.value < 0:
                yield idx, None
                continue
            out = np.ctypeslib.as_array(data, shape=(n.value,)).copy()
            self._lib.modmfcc_free(data)
            yield idx, out

    def close(self):
        if self._h:
            self._lib.modmfcc_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
