"""modulation_mfcc — accelerator-native acoustic feature extraction.

A ground-up JAX/XLA rebuild of the capabilities of
``aaron-randreth/modulation-mfcc`` (see SURVEY.md): MFCC modulation cepstrum,
modulation spectra, F0, formants, amplitude envelopes, derivatives, peak
analysis, TextGrid/EMA I/O and CSV export — as a pure-functional, batched,
mesh-shardable library instead of a Qt desktop app.
"""
import os as _os


# fixed in-checkout location of the persistent compilation cache: the path
# is part of the cache key, so a directory that moves never hits
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))), ".jax_cache"
)


def _setup_compilation_cache() -> None:
    """Persistent XLA compilation cache (opt out: MODMFCC_NO_CACHE=1).

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left alone; otherwise the cache lives at :data:`CACHE_DIR`.
    """
    if _os.environ.get("MODMFCC_NO_CACHE") or _os.environ.get(
        "JAX_COMPILATION_CACHE_DIR"
    ):
        return
    try:
        import jax

        if jax.config.jax_compilation_cache_dir is None:
            jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
            jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass


def _harden_cache_writes() -> None:
    """Make persistent-cache entry writes atomic (tmp file + os.replace).

    jax's file-system cache (jax._src.lru_cache.LRUCache.put) publishes an
    entry with a bare ``write_bytes`` and never overwrites an existing key
    ("if cache_path.exists(): return"), so a process killed mid-write — a
    ``timeout``-bounded driving script — leaves a PERMANENTLY truncated
    entry. Deserializing one segfaults CPython inside
    ``backend.deserialize_executable``. Publishing via ``os.replace`` makes a
    torn write impossible; an orphaned ``*-tmp`` file from a kill during
    the tmp write is invisible to cache gets and to the LRU eviction glob
    (``*-cache``) — dead weight, never poison. Last-write-wins replace
    also HEALS a pre-existing truncated entry whose read failed cleanly
    (jax treats a raising read as a miss and recompiles; stock
    first-write-wins would then refuse the good rewrite). A truncation
    that segfaults deserialization still needs a manual cache wipe — but
    this patch makes new ones impossible.

    Best-effort: any jax-internals mismatch degrades to the stock
    (non-atomic) behavior rather than failing.
    """
    try:
        import tempfile

        from jax._src import lru_cache as _lru

        if getattr(_lru.LRUCache, "_modmfcc_atomic_put", False):
            return
        _orig_put = _lru.LRUCache.put

        def _put(self, key: str, val: bytes) -> None:
            # with eviction enabled the stock put's lock/atime/evict logic
            # must run as one unit — keep it (and its non-atomicity) there;
            # both this package and the test suite run with eviction off.
            if getattr(self, "eviction_enabled", True):
                _orig_put(self, key, val)
                return
            try:
                path = self.path / f"{key}-cache"
                fd, tmp = tempfile.mkstemp(
                    dir=str(self.path), prefix=".put-", suffix="-tmp"
                )
                try:
                    with _os.fdopen(fd, "wb") as fh:
                        fh.write(val)
                    # the original put's exists() check makes first-write-wins
                    # the contract; replace keeps last-write-wins, which is
                    # equally valid (entries for one key are identical) and
                    # additionally HEALS any pre-existing truncated entry.
                    _os.replace(tmp, str(path))
                    tmp = None
                finally:
                    if tmp is not None:
                        try:
                            _os.unlink(tmp)
                        except OSError:
                            pass
            except Exception:
                _orig_put(self, key, val)

        _put.__doc__ = _orig_put.__doc__
        _lru.LRUCache.put = _put
        _lru.LRUCache._modmfcc_atomic_put = True
    except Exception:
        pass


_setup_compilation_cache()
_harden_cache_writes()

from modulation_mfcc.models.config import (
    AmplitudeConfig,
    EmaConfig,
    F0Config,
    FormantConfig,
    MfccConfig,
    PipelineConfig,
    config_from_reference_json,
    config_to_reference_json,
)
from modulation_mfcc.models.modulation import (
    extract_mfcc_change,
    mfcc_change,
    mfcc_trajectories,
    modulation_spectrum,
)

# BASELINE.json API names: extract_mfcc / extract_modulation
extract_modulation = extract_mfcc_change


def extract_mfcc(y, cfg: "MfccConfig" = None, **kw):
    """(times, mfcc [NF, n_mfcc]) — librosa-semantics MFCC matrix (jitted,
    bucket-padded so lengths within a bucket share one compile)."""
    from modulation_mfcc.models.modulation import extract_mfcc_matrix

    return extract_mfcc_matrix(y, cfg or MfccConfig(), **kw)

__version__ = "0.1.0"
