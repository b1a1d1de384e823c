"""Multi-device (virtual 8-CPU mesh) + streaming paths: sharded data-parallel
extraction, chunked long-form == whole-file, time-sharded long-form parity."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.models.modulation import mfcc_change
from modulation_mfcc.parallel.batch import pad_batch, sharded_mfcc_change
from modulation_mfcc.parallel.mesh import make_mesh
from modulation_mfcc.parallel.streaming import (
    chunked_mfcc_change,
    sharded_longform_mfcc_change,
)


def small_cfg():
    return MfccConfig(n_fft=256, n_mels=40)


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.shape["data"] == 8 and mesh.shape["time"] == 1
    mesh2 = make_mesh(4, 2)
    assert mesh2.shape["data"] == 4 and mesh2.shape["time"] == 2


def test_sharded_matches_unsharded(rng):
    cfg = small_cfg()
    sigs = [rng.standard_normal(4000 + 512 * (i % 3)).astype(np.float32) for i in range(8)]
    batch = pad_batch(sigs, bucket_multiple=1024)
    mesh = make_mesh(8, 1)
    tot_s, mask, mean_change = sharded_mfcc_change(batch, cfg, mesh)
    nf = 1 + batch.lengths // cfg.hop_length
    tot_u = mfcc_change(batch.samples, cfg, frame_lengths=nf)
    np.testing.assert_allclose(
        np.asarray(tot_s) * np.asarray(mask),
        np.asarray(tot_u) * np.asarray(mask),
        atol=1e-5,  # f32: sharded vs unsharded differ only in reduction order
    )
    assert np.isfinite(float(mean_change))


def test_chunked_longform_equals_wholefile(rng):
    cfg = small_cfg()
    y = jnp.asarray(rng.standard_normal(120_000), dtype=jnp.float64)
    whole = mfcc_change(y, cfg)
    chunked = chunked_mfcc_change(y, cfg, frames_per_chunk=512)
    np.testing.assert_allclose(np.asarray(chunked), np.asarray(whole), atol=1e-8)
    # the bounded-memory two-pass schedule (forced via a zero mel-stack
    # cap) must produce the identical numbers — it re-derives the mel per
    # chunk instead of stacking it, nothing else
    two_pass = chunked_mfcc_change(
        y, cfg, frames_per_chunk=512, mel_stack_cap_bytes=0
    )
    np.testing.assert_array_equal(np.asarray(two_pass), np.asarray(chunked))


def test_time_sharded_longform_matches_wholefile(rng):
    cfg = small_cfg()
    y = jnp.asarray(rng.standard_normal(64_000), dtype=jnp.float32)
    mesh = make_mesh(1, 8)
    got = sharded_longform_mfcc_change(y, cfg, mesh)
    want = mfcc_change(y, cfg)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)


def test_multislice_mesh_matches_single(rng):
    """('slice','data','time') mesh: the 2-slice layout must produce the
    same features + corpus stats as the single-mesh path (the 'slice' leg
    rides DCN on real hardware; here it's a local device group)."""
    from modulation_mfcc.parallel.batch import pad_batch, sharded_mfcc_change
    from modulation_mfcc.parallel.multislice import (
        make_multislice_mesh,
        multislice_sharded_mfcc_change,
        shard_manifest,
    )

    cfg = small_cfg()
    sigs = [rng.standard_normal(4000 + 500 * (i % 3)) for i in range(8)]
    batch = pad_batch(sigs, bucket_multiple=1024)
    mesh_ms = make_multislice_mesh(2, 2, 2)
    tot_ms, mask_ms, mean_ms = multislice_sharded_mfcc_change(batch, cfg, mesh_ms)
    mesh_1 = make_mesh(8, 1)
    tot_1, mask_1, mean_1 = sharded_mfcc_change(batch, cfg, mesh_1)
    np.testing.assert_allclose(
        np.asarray(tot_ms) * np.asarray(mask_ms),
        np.asarray(tot_1) * np.asarray(mask_1),
        atol=1e-5,
    )
    assert abs(float(mean_ms) - float(mean_1)) < 1e-6

    # manifest sharding: disjoint, covering, balanced
    paths = [f"f{i}.wav" for i in range(11)]
    shards = [shard_manifest(paths, 3, s) for s in range(3)]
    assert sorted(sum(shards, [])) == sorted(paths)
    assert max(len(s) for s in shards) - min(len(s) for s in shards) <= 1


def test_time_sharded_longform_nondivisible_length(rng):
    """Signal lengths need not divide the time axis: the shard geometry pads
    internally and masks the tail (VERDICT round-1 item 9)."""
    cfg = small_cfg()
    y = jnp.asarray(rng.standard_normal(64_000 + 4321), dtype=jnp.float32)
    mesh = make_mesh(1, 8)
    got = sharded_longform_mfcc_change(y, cfg, mesh)
    want = mfcc_change(y, cfg)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-4)


def test_graft_entry_single_and_multi():
    import importlib.util, pathlib

    spec = importlib.util.spec_from_file_location(
        "graft_entry", pathlib.Path(__file__).resolve().parents[1] / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    assert np.all(np.isfinite(np.asarray(out)))
    mod.dryrun_multichip(8)
