"""Every product on the device paths states its precision.

A float32 dot or convolution at DEFAULT precision may run with TF32
operands on the GPU (about three decimal digits). The audit traces each
public jitted pipeline and requires every ``dot_general`` and
``conv_general_dilated`` to carry ``Precision.HIGHEST`` — or bf16/int8
operands, and only in pipelines whose spectrum tier asks for them by name.

Also pinned here: 'auto' engine choices do not depend on the platform, and
the retired fused-kernel spectrum names fail with their replacement.
"""
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from modulation_mfcc.models.config import (
    AmplitudeConfig,
    F0Config,
    FormantConfig,
    MfccConfig,
)

CFG16 = MfccConfig(signal_sample_rate=16_000, maxFreq=8000.0)
_LOW = (jnp.bfloat16, jnp.int8)
_HIGHEST = jax.lax.Precision.HIGHEST


def _sub_jaxprs(v):
    if hasattr(v, "eqns"):
        yield v
    elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
        yield v.jaxpr
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _sub_jaxprs(x)


def _products(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
            yield eqn
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                yield from _products(sub)


def _audit(fn, *args, allow_low: bool):
    """(n_products, offending) for the traced pipeline."""
    jaxpr = jax.make_jaxpr(fn)(*args).jaxpr
    bad, n = [], 0
    for eqn in _products(jaxpr):
        n += 1
        dts = {v.aval.dtype for v in eqn.invars}
        if all(d in _LOW for d in dts):
            if not allow_low:
                bad.append(f"{eqn.primitive.name} on {sorted(map(str, dts))} (no tier asked)")
            continue
        prec = eqn.params.get("precision")
        precs = prec if isinstance(prec, tuple) else (prec,)
        if not all(p == _HIGHEST for p in precs):
            bad.append(f"{eqn.primitive.name} on {sorted(map(str, dts))} precision={prec}")
    return n, bad


def _audio(n, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal((b, n)), jnp.float32)


def _mfcc_change(spectrum):
    from modulation_mfcc.models.modulation import mfcc_change

    return (lambda y: mfcc_change(y, CFG16, spectrum=spectrum)), (_audio(24_000),)


def _masked(spectrum):
    from modulation_mfcc.parallel.batch import AudioBatch, batched_mfcc_change

    lengths = jnp.asarray([64_000, 60_000], jnp.int32)
    return (
        lambda y: batched_mfcc_change(
            AudioBatch(y, lengths), CFG16, spectrum=spectrum, masked_fir=True
        )[0],
        (_audio(64_000),),
    )


def _rows(spectrum):
    from modulation_mfcc.models.modulation import mfcc_change
    from modulation_mfcc.ops.framing import pack_hop_rows

    pcm = (np.random.default_rng(1).standard_normal((2, 24_000)) * 8000).astype(np.int16)
    rows = jnp.asarray(pack_hop_rows(pcm, n_fft=512, hop=80))
    return (lambda r: mfcc_change(r, CFG16, spectrum=spectrum, n_samples=24_000)), (rows,)


def _modspec(spectrum):
    from modulation_mfcc.models.modulation import modulation_spectrum

    return (lambda y: modulation_spectrum(y, CFG16, spectrum=spectrum)), (_audio(24_000),)


def _chunked():
    from modulation_mfcc.parallel.streaming import chunked_mfcc_change

    return (lambda y: chunked_mfcc_change(y, CFG16, frames_per_chunk=256)), (_audio(48_000, 1)[0],)


def _sharded_longform():
    from modulation_mfcc.parallel.mesh import make_mesh
    from modulation_mfcc.parallel.streaming import sharded_longform_mfcc_change

    mesh = make_mesh(1, 4)
    return (lambda y: sharded_longform_mfcc_change(y, CFG16, mesh)), (_audio(48_000, 1)[0],)


def _extras():
    from modulation_mfcc.parallel.corpus import _extras_impl

    lengths = jnp.asarray([24_000, 20_000], jnp.int32)
    feats = ("mfcc39", "f0", "envelope", "formants")
    return (
        lambda y: _extras_impl(y, lengths, CFG16, "matmul", feats, F0Config(),
                               AmplitudeConfig(), FormantConfig(), None),
        (_audio(24_000),),
    )


def _pitch(method, engine):
    from modulation_mfcc.ops.pitch import pitch_ac

    return (lambda y: pitch_ac(y, sr=10_000.0, method=method, ac_engine=engine)), (_audio(20_000, 1)[0],)


def _pyin(engine):
    from modulation_mfcc.ops.yin import pyin_f0

    return (lambda y: pyin_f0(y, sr=10_000.0, cmndf_engine=engine)), (_audio(20_000, 1)[0],)


def _small_ops():
    from modulation_mfcc.models.envelope import rms_envelope
    from modulation_mfcc.ops.derivatives import velocity
    from modulation_mfcc.ops.hilbert import hilbert_envelope
    from modulation_mfcc.ops.intensity import intensity_db
    from modulation_mfcc.ops.lpc import lpc_formants
    from modulation_mfcc.ops.resample import resample_device

    def fn(y):
        return (
            intensity_db(y, sr=10_000.0),
            lpc_formants(y, sr=10_000.0, max_formant=5000.0),
            rms_envelope(y, 250, 50),
            hilbert_envelope(y),
            velocity(y, 100.0, method="finDiff"),
            velocity(y, 100.0, method="sg", width=7),
            resample_device(y, 10_000.0, 16_000.0),
        )

    return fn, (_audio(20_000, 1)[0],)


PIPELINES = {
    **{f"mfcc_change[{s}]": (lambda s=s: _mfcc_change(s), s not in ("fft", "matmul"))
       for s in ("fft", "matmul", "matmul_x3", "matmul_bf16", "matmul_i24", "matmul_i16")},
    "masked_fir[matmul]": (lambda: _masked("matmul"), False),
    "masked_fir[matmul_bf16]": (lambda: _masked("matmul_bf16"), True),
    "hop_rows[matmul_i16]": (lambda: _rows("matmul_i16"), True),
    "modulation_spectrum[fft]": (lambda: _modspec("fft"), False),
    "modulation_spectrum[matmul_bf16]": (lambda: _modspec("matmul_bf16"), True),
    "chunked_mfcc_change": (_chunked, False),
    "sharded_longform": (_sharded_longform, False),
    "corpus_extras": (_extras, False),
    "pitch[ac,matmul]": (lambda: _pitch("ac", "matmul"), False),
    "pitch[cc,matmul]": (lambda: _pitch("cc", "matmul"), False),
    "pyin[matmul]": (lambda: _pyin("matmul"), False),
    "pyin[fft]": (lambda: _pyin("fft"), False),
    "trackers_and_ops": (_small_ops, False),
}


@pytest.mark.parametrize("name", list(PIPELINES))
def test_products_state_precision(name):
    build, allow_low = PIPELINES[name]
    fn, args = build()
    n, bad = _audit(fn, *args, allow_low=allow_low)
    assert n > 0, "pipeline traced no product at all"
    assert not bad, bad


@pytest.mark.parametrize("backend", ["cpu", "gpu", "rocm"])
def test_auto_engines_ignore_backend(backend, monkeypatch):
    """'auto' resolves to the same form whatever default_backend() says:
    the FFT autocorrelation, the FFT CMNDF and the framed modulation
    spectrum (identical traced programs to the explicit engines)."""
    from modulation_mfcc.models.modulation import modulation_spectrum
    from modulation_mfcc.ops.pitch import pitch_ac
    from modulation_mfcc.ops.yin import pyin_f0

    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    y = _audio(20_000, 1)[0]
    pairs = [
        (lambda x: pitch_ac(x, sr=10_000.0), lambda x: pitch_ac(x, sr=10_000.0, ac_engine="fft")),
        (lambda x: pitch_ac(x, sr=10_000.0, method="cc"),
         lambda x: pitch_ac(x, sr=10_000.0, method="cc", ac_engine="fft")),
        (lambda x: pyin_f0(x, sr=10_000.0), lambda x: pyin_f0(x, sr=10_000.0, cmndf_engine="fft")),
    ]
    for auto, explicit in pairs:
        jax.clear_caches()
        a = str(jax.make_jaxpr(auto)(y))
        jax.clear_caches()
        assert a == str(jax.make_jaxpr(explicit)(y))
    jaxpr = str(jax.make_jaxpr(lambda x: modulation_spectrum(x, CFG16))(_audio(24_000)))
    assert "conv_general_dilated" not in jaxpr and "fft" in jaxpr


def test_no_platform_branches_in_package():
    """Engine choice never tests the platform: no `default_backend() ==`
    comparison anywhere in the package."""
    pkg = pathlib.Path(__file__).resolve().parents[1] / "modulation_mfcc"
    hits = [
        f"{p.relative_to(pkg)}:{i}"
        for p in pkg.rglob("*.py")
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if "default_backend() ==" in line or "default_backend() !=" in line
    ]
    assert not hits, hits


@pytest.mark.parametrize(
    "old,new",
    [("pallas", "matmul"), ("pallas_x3", "matmul_x3"), ("pallas_bf16", "matmul_bf16"),
     ("pallas_i24", "matmul_i24"), ("pallas_i16", "matmul_i16")],
)
def test_retired_spectrum_names_point_to_replacement(old, new):
    from modulation_mfcc.models.modulation import mfcc_change

    with pytest.raises(ValueError, match=f"'{new}'"):
        mfcc_change(_audio(8_000), CFG16, spectrum=old)
