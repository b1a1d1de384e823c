"""Multi-slice (DCN) scale-out for corpus sweeps.

The reference has no distributed execution at all (SURVEY.md §2e); the
single-slice layer (parallel/mesh.py) covers one ICI domain. This module is
the cross-slice tier named in SURVEY.md §5 ("DCN for multi-slice corpus
sweeps"):

  * the device mesh gains a leading ``slice`` axis. Inside a slice,
    collectives ride ICI; across slices they ride DCN. Corpus extraction is
    embarrassingly parallel over utterances, so the only cross-slice traffic
    is the tiny corpus-stats all-reduce (one psum over ('slice', 'data')) —
    exactly the communication profile DCN is good at (low bandwidth, latency
    tolerant), while the heavy audio/feature tensors never leave a slice.
  * at the FILE level, sweeps shard the manifest per process: each host
    feeds its own slice from local storage and writes its own output
    directory; resume tracking stays per-process (no coordination needed
    beyond the optional stats reduce).

Deployment: call :func:`init_distributed` once per process (cluster
style: coordinator address + process count via env or args), then
``make_multislice_mesh``. On a single host (CI, this repo's tests) the same
code runs on the virtual CPU mesh — ``jax.distributed`` is simply not
initialized and all "slices" are local device groups, which preserves the
program structure and lets the sharding/collective layout compile and
execute without DCN hardware (SURVEY.md §4's testability rule).
"""
from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from modulation_mfcc.models.config import MfccConfig
from modulation_mfcc.parallel.batch import AudioBatch, batched_mfcc_change

__all__ = [
    "init_distributed",
    "make_multislice_mesh",
    "multislice_sharded_mfcc_change",
    "shard_manifest",
]


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed for a real multi-host/multi-slice job.

    Arguments default from the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID). Returns True when a multi-process
    runtime was initialized, False for the single-process (local/CI) case —
    callers use the same code path either way.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if coordinator_address is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes
        or int(os.environ.get("JAX_NUM_PROCESSES", "1")),
        process_id=process_id or int(os.environ.get("JAX_PROCESS_ID", "0")),
    )
    return True


def make_multislice_mesh(
    n_slice: int, n_data: int | None = None, n_time: int = 1, *, devices=None
) -> Mesh:
    """A ('slice', 'data', 'time') mesh.

    On real multi-slice hardware, order devices so that the leading axis
    varies slowest across slices (jax.devices() already groups by process →
    by slice), putting 'slice'-axis collectives on DCN and keeping
    'data'/'time' inside each slice's ICI domain. On a single slice or the
    virtual CPU mesh the same construction yields local device groups.
    """
    devices = devices if devices is not None else jax.devices()
    if n_data is None:
        n_data = len(devices) // (n_slice * n_time)
    need = n_slice * n_data * n_time
    if need > len(devices):
        raise ValueError(
            f"mesh {n_slice}x{n_data}x{n_time} needs {need} devices, "
            f"have {len(devices)}"
        )
    use = np.array(devices[:need]).reshape(n_slice, n_data, n_time)
    return Mesh(use, axis_names=("slice", "data", "time"))


def multislice_sharded_mfcc_change(
    batch: AudioBatch,
    cfg: MfccConfig,
    mesh: Mesh,
    *,
    spectrum: str | None = None,
    masked_fir: bool = False,
):
    """(tot [B, NF], mask [B, NF], corpus mean) with the batch sharded over
    ('slice', 'data') jointly.

    GSPMD layout: per-utterance extraction is fully local to a device; the
    only collective is the scalar stats psum, whose 'slice' leg rides DCN in
    a real deployment. XLA inserts it from the sharding annotations — no
    hand-written communication.
    """
    import functools

    @functools.partial(
        jax.jit, static_argnames=("cfg", "spectrum", "masked_fir", "mesh")
    )
    def impl(samples, lengths, cfg, spectrum, masked_fir, mesh):
        samples = jax.lax.with_sharding_constraint(
            samples, NamedSharding(mesh, P(("slice", "data"), None))
        )
        lengths = jax.lax.with_sharding_constraint(
            lengths, NamedSharding(mesh, P(("slice", "data")))
        )
        tot, mask = batched_mfcc_change(
            AudioBatch(samples, lengths), cfg, spectrum=spectrum,
            masked_fir=masked_fir,
        )
        n_frames = jnp.sum(mask)
        mean_change = jnp.sum(tot * mask) / jnp.maximum(n_frames, 1.0)
        return tot, mask, mean_change

    return impl(batch.samples, batch.lengths, cfg, spectrum, masked_fir, mesh)


def shard_manifest(paths: list[str], n_shards: int, shard_id: int) -> list[str]:
    """Deterministic file-level sharding for multi-process sweeps: process
    ``shard_id`` of ``n_shards`` takes every n-th file (round-robin keeps
    per-shard duration balanced for roughly-sorted corpora)."""
    if not (0 <= shard_id < n_shards):
        raise ValueError(f"shard_id {shard_id} not in [0, {n_shards})")
    return paths[shard_id::n_shards]
