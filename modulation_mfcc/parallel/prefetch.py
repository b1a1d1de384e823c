"""Host→device input pipeline: decode-ahead + device prefetch.

The reference loads each file synchronously on the GUI thread
(script/main.py:943); corpus extraction instead runs a two-stage pipeline:

  host thread(s): WAV decode + resample + pad into pinned numpy batches
  prefetcher:     copies the next batch to device while the current one
                  computes (double buffering: `jax.device_put` is async, so
                  keeping N batches in flight overlaps H2D DMA with compute)

Single-core hosts still win: the device queue never drains while Python
decodes the next bucket.
"""
from __future__ import annotations

import queue
import threading
from collections.abc import Iterable, Iterator

import jax

__all__ = ["prefetch_to_device", "background_iter"]


def background_iter(it: Iterable, maxsize: int = 4) -> Iterator:
    """Run an iterator in a daemon thread, buffering up to ``maxsize`` items
    (the host decode stage)."""
    q: queue.Queue = queue.Queue(maxsize=maxsize)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            q.put(e)
        finally:
            q.put(_END)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def _placement(x, device, mesh):
    """Where one leaf goes: under a mesh, its leading (batch) axis sharded
    over 'data' (replicated when the batch does not divide the axis — the
    consumer's sharding constraint then splits it); else ``device``."""
    if mesh is None:
        return device
    from jax.sharding import NamedSharding, PartitionSpec

    from modulation_mfcc.parallel.mesh import data_sharding

    if x.ndim and x.shape[0] % mesh.shape["data"] == 0:
        return data_sharding(mesh, x.ndim)
    return NamedSharding(mesh, PartitionSpec())


def prefetch_to_device(
    batches: Iterable, depth: int = 2, device=None, stats: dict | None = None,
    mesh=None,
) -> Iterator:
    """Keep ``depth`` batches resident on device ahead of the consumer.

    Each item is a pytree of numpy arrays; returns the same pytrees as
    device arrays. Transfers are issued eagerly so the copy of batch k+1
    overlaps the computation on batch k. With a ``mesh`` every batch lands
    sharded over its 'data' axis, so each device receives only its rows.

    ``stats`` (optional) accumulates upload accounting WITHOUT changing the
    pipeline shape: ``upload_mb`` (bytes issued) and ``upload_busy_s`` (link
    occupancy — a daemon thread blocks on each transfer in issue order and
    sums the non-overlapping [issue, ready] intervals, so time a transfer
    spends queued behind the previous one isn't double-counted)."""
    import time

    buf: list = []
    it = iter(batches)

    acct_q: queue.Queue | None = None
    acct_thread = None
    if stats is not None:
        stats.setdefault("upload_mb", 0.0)
        stats.setdefault("upload_busy_s", 0.0)
        acct_q = queue.Queue()

        def _acct():
            last_ready = 0.0
            while True:
                item = acct_q.get()
                if item is None:
                    return
                t_issue, tree = item
                try:
                    for leaf in jax.tree_util.tree_leaves(tree):
                        leaf.block_until_ready()
                except Exception:
                    # a failed transfer surfaces in the main loop; keep
                    # draining so later batches' accounting (and their
                    # device-array references held by the queue) don't pile
                    # up behind a dead thread
                    continue
                t_ready = time.perf_counter()
                stats["upload_busy_s"] += max(0.0, t_ready - max(t_issue, last_ready))
                last_ready = t_ready

        acct_thread = threading.Thread(target=_acct, daemon=True)
        acct_thread.start()

    def put(item):
        if stats is not None:
            stats["upload_mb"] += (
                sum(x.nbytes for x in jax.tree_util.tree_leaves(item)) / 1e6
            )
        t0 = time.perf_counter()
        out = jax.tree_util.tree_map(
            lambda x: jax.device_put(x, _placement(x, device, mesh)), item
        )
        if acct_q is not None:
            acct_q.put((t0, out))
        return out

    try:
        try:
            for _ in range(depth):
                buf.append(put(next(it)))
        except StopIteration:
            pass
        while buf:
            out = buf.pop(0)
            try:
                buf.append(put(next(it)))
            except StopIteration:
                pass
            yield out
    finally:
        if acct_q is not None:
            acct_q.put(None)
            acct_thread.join(timeout=60.0)
