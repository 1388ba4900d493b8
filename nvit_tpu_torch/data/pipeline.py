"""Input pipeline (≙ nvit_tpu/data/pipeline.py): seeded per-epoch order
(sharded by stride across processes), host batches of in-memory arrays
(native gather) and of JPEG folders (a thread pool decoding ahead), and
``device_prefetch``, which keeps ``size`` uploaded batches in flight.

On a CUDA device the upload runs on a side stream: the producer thread
copies each pinned host batch with ``non_blocking=True`` and records an
event; the consumer makes its current stream wait on that event and marks
the tensors with ``record_stream``, so the caching allocator does not hand
their memory back to the producer while a step still reads them.  A pinned
host buffer is held until its copy's event has completed.  On the CPU the
same thread hands over tensors that share the host arrays' memory.
Normalization and AutoAugment run on the device (``data/augment.py``).
"""

from __future__ import annotations

import collections
import concurrent.futures
import threading
from typing import Iterator

import numpy as np
import torch

from nvit_tpu_torch.data import native
from nvit_tpu_torch.data.datasets import ArrayDataset, ImageFolderDataset

Batch = tuple[np.ndarray, np.ndarray]  # (images u8 [B, C, H, W], labels i32 [B])


def epoch_indices(
    n: int, *, epoch: int, seed: int, shuffle: bool, shard_index: int = 0, shard_count: int = 1,
) -> np.ndarray:
    """The epoch's index order (≙ pipeline.py:epoch_indices): a permutation
    seeded by ``seed + epoch``; with several shards, equal-length strided
    slices ``idx[shard_index::shard_count]`` of it."""
    idx = np.random.RandomState(seed + epoch).permutation(n) if shuffle else np.arange(n)
    if shard_count > 1:
        idx = idx[: len(idx) - (len(idx) % shard_count)][shard_index::shard_count]
    return idx


def _batch_starts(n: int, batch_size: int, drop_last: bool, start_batch: int) -> range:
    end = n - (n % batch_size) if drop_last else n
    return range(max(0, start_batch) * batch_size, end, batch_size)


def iterate_array(
    ds: ArrayDataset, *, batch_size: int, epoch: int = 0, seed: int = 42, shuffle: bool = True,
    drop_last: bool = True, shard_index: int = 0, shard_count: int = 1, start_batch: int = 0,
) -> Iterator[Batch]:
    """Host batches of ``ds`` in the epoch's order, gathered by
    ``native.gather_rows``; ``start_batch`` skips the first batches."""
    idx = epoch_indices(len(ds), epoch=epoch, seed=seed, shuffle=shuffle,
                        shard_index=shard_index, shard_count=shard_count)
    for start in _batch_starts(len(idx), batch_size, drop_last, start_batch):
        sel = idx[start:start + batch_size]
        yield native.gather_rows(ds.images, sel), ds.labels[sel]


def iterate_folder(
    ds: ImageFolderDataset, *, batch_size: int, epoch: int = 0, seed: int = 42, shuffle: bool = True,
    drop_last: bool = True, num_workers: int = 4, shard_index: int = 0, shard_count: int = 1,
    start_batch: int = 0,
) -> Iterator[Batch]:
    """Host batches of a JPEG folder (≙ pipeline.py:iterate_folder): a pool
    of ``num_workers`` threads decodes that many batches ahead; the pool
    shuts down, its queued batches cancelled, when the iterator ends or is
    abandoned."""
    idx = epoch_indices(len(ds), epoch=epoch, seed=seed, shuffle=shuffle,
                        shard_index=shard_index, shard_count=shard_count)
    starts = list(_batch_starts(len(idx), batch_size, drop_last, start_batch))
    if not starts:
        return
    ahead = max(1, num_workers)
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=ahead, thread_name_prefix="nvit-decode")

    def decode(start: int) -> Batch:
        sel = idx[start:start + batch_size]
        return ds.decode_batch(sel), ds.labels[sel]

    try:
        pending = collections.deque(pool.submit(decode, s) for s in starts[:ahead])
        queued = iter(starts[ahead:])
        while pending:
            fut = pending.popleft()
            if (s := next(queued, None)) is not None:
                pending.append(pool.submit(decode, s))
            yield fut.result()
    finally:
        pool.shutdown(wait=False, cancel_futures=True)


def make_epoch_iterator(
    ds, *, batch_size: int, epoch: int, seed: int, shuffle: bool, drop_last: bool = True,
    num_workers: int = 4, shard_index: int = 0, shard_count: int = 1, start_batch: int = 0,
) -> Iterator[Batch]:
    """The epoch's host batches of an array or folder dataset (≙
    pipeline.py:make_epoch_iterator).  ``start_batch`` skips the first
    batches without decoding them, so a resumed run sees the batch the
    interrupted launch would have seen next."""
    kw = dict(batch_size=batch_size, epoch=epoch, seed=seed, shuffle=shuffle, drop_last=drop_last,
              shard_index=shard_index, shard_count=shard_count, start_batch=start_batch)
    if isinstance(ds, ImageFolderDataset):
        return iterate_folder(ds, num_workers=num_workers, **kw)
    return iterate_array(ds, **kw)


class _ProducerError:
    """An exception of the producer thread, re-raised by the consumer: a bad
    batch fails the epoch instead of ending it early."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def device_prefetch(it: Iterator[Batch], device: torch.device | str, *, size: int = 2
                    ) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Upload up to ``size`` batches of ``it`` ahead of their use, on a
    producer thread (≙ pipeline.py:device_prefetch).  The producer's
    exceptions are re-raised here; ending early (``break``, ``close()``)
    stops the thread, drops the queued batches and closes ``it``."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device=device) if cuda else None
    q: collections.deque = collections.deque()
    cond = threading.Condition()
    done = object()
    stop = threading.Event()

    def producer():
        in_flight: collections.deque = collections.deque()  # (event, host tensors) of copies
        try:
            for batch in it:
                # uint8 images (a quarter of the fp32 bytes) and int64 labels
                imgs, labels = (torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
                event = None
                if not cuda:
                    labels = labels.to(torch.int64)
                else:
                    host = imgs.pin_memory(), labels.pin_memory()
                    with torch.cuda.stream(side):
                        imgs = host[0].to(device, non_blocking=True)
                        labels = host[1].to(device, torch.int64, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(side)
                    in_flight.append((event, host))
                    while in_flight and in_flight[0][0].query():
                        in_flight.popleft()  # the copy is done: its pinned buffer may go
                with cond:
                    while len(q) >= max(1, size) and not stop.is_set():
                        cond.wait()
                    if stop.is_set():
                        return
                    q.append((imgs, labels, event))
                    cond.notify_all()
        except BaseException as e:  # noqa: BLE001 — handed to the consumer, which re-raises
            with cond:
                q.append(_ProducerError(e))
                cond.notify_all()
        else:
            with cond:
                q.append(done)
                cond.notify_all()
        finally:
            for event, _ in in_flight:  # the host buffers outlive their copies
                event.synchronize()

    thread = threading.Thread(target=producer, daemon=True, name="nvit-prefetch")
    thread.start()
    try:
        while True:
            with cond:
                while not q:
                    cond.wait()
                item = q.popleft()
                cond.notify_all()
            if item is done:
                return
            if isinstance(item, _ProducerError):
                raise item.exc
            imgs, labels, event = item
            if cuda:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                imgs.record_stream(current)
                labels.record_stream(current)
            yield imgs, labels
    finally:
        with cond:
            stop.set()
            q.clear()
            cond.notify_all()
        thread.join(timeout=5)
        close = getattr(it, "close", None)
        if close is not None and not thread.is_alive():
            close()  # the source's own resources (iterate_folder's pool)
