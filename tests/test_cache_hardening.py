"""Atomic persistent-cache writes (modulation_mfcc._harden_cache_writes).

jax's stock LRUCache.put publishes entries with a bare write_bytes and
never overwrites an existing key, so a kill mid-write leaves a permanently
truncated entry; deserializing one segfaults the process until the cache
dir is wiped. The package patches put to tmp-file + os.replace when
eviction is off. These tests pin the patch and the cache's location.
"""
import os
import pathlib
import subprocess
import sys

import pytest

import modulation_mfcc  # noqa: F401  (applies the patch on import)

from jax._src import lru_cache


def _mkcache(tmp_path):
    return lru_cache.LRUCache(str(tmp_path), max_size=-1)


def test_patch_applied():
    assert getattr(lru_cache.LRUCache, "_modmfcc_atomic_put", False)


def test_put_writes_entry_and_leaves_no_tmp(tmp_path):
    c = _mkcache(tmp_path)
    c.put("k1", b"payload-bytes")
    assert (tmp_path / "k1-cache").read_bytes() == b"payload-bytes"
    assert c.get("k1") == b"payload-bytes"
    leftovers = [p for p in os.listdir(tmp_path) if p.endswith("-tmp")]
    assert leftovers == []


def test_put_heals_truncated_entry(tmp_path):
    # a kill mid-write under stock jax leaves a short file that put will
    # never repair (first-write-wins); the atomic patch replaces it.
    c = _mkcache(tmp_path)
    (tmp_path / "k2-cache").write_bytes(b"trunc")
    c.put("k2", b"the-full-serialized-executable")
    assert (tmp_path / "k2-cache").read_bytes() == b"the-full-serialized-executable"


def test_orphan_tmp_invisible_to_get(tmp_path):
    c = _mkcache(tmp_path)
    (tmp_path / ".put-orphan-tmp").write_bytes(b"garbage")
    assert c.get("nokey") is None
    c.put("k3", b"v")
    assert c.get("k3") == b"v"


@pytest.mark.parametrize("env_dir", [False, True], ids=["fixed_path", "env_var"])
def test_compile_cache_placement(tmp_path, env_dir):
    """Unset JAX_COMPILATION_CACHE_DIR → the cache sits at the fixed
    in-checkout path; set → JAX's own setting stands, nothing overrides it."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "MODMFCC_NO_CACHE")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(repo))
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax, modulation_mfcc as m;"
         "print(jax.config.jax_compilation_cache_dir); print(m.CACHE_DIR)"],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(tmp_path),
    )
    assert r.returncode == 0, r.stderr
    got, fixed = r.stdout.split()
    assert fixed == str(repo / ".jax_cache")
    assert got == (str(tmp_path) if env_dir else fixed)
