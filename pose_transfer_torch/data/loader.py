"""Host-side batching and device prefetch.

Counterpart of ``pose_transfer_tpu/data/loader.py``:

- ``BatchStream`` is an infinite shuffled batch iterator with a seeded
  reshuffle per pass over the dataset; the same seed draws the same index
  sequence as the JAX package's, ``seek_batches`` included. A data-parallel
  rank (``rank`` of ``world``) draws the same global batches and decodes
  only its rows of each, so the ranks together see the single-device
  run's batches.
- Samples are assembled by a thread pool (image decode and least-squares
  fits are numpy and zlib, which release the GIL in their hot parts).
- ``DevicePrefetcher`` keeps batches assembled ahead. On a CUDA device each
  batch is copied from pinned host memory with ``non_blocking`` copies on
  a side stream, and an event marks the copy's end; the consumer's stream
  waits on that event and the tensors are ``record_stream``-ed on it, so
  that the caching allocator does not hand their memory to a later copy
  on the side stream while the consumer still reads them. On the CPU it
  only assembles ahead, into tensors.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .dataset import collate


class BatchStream:
    """Infinite shuffled batch iterator over a map-style dataset: global
    batches of ``batch_size``, of which this stream assembles rank
    ``rank``'s ``batch_size // world`` rows."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, num_threads: int = 8, rank: int = 0,
                 world: int = 1):
        if batch_size % world:
            raise ValueError(f"batch_size {batch_size} does not divide over "
                             f"{world} ranks")
        self.dataset = dataset
        self.batch_size = batch_size
        self.rank, self.world = rank, world
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)
        self._idx_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=num_threads) \
            if num_threads > 1 else None
        self._order: np.ndarray = np.array([], dtype=np.int64)
        self._pos = 0
        self.epochs_completed = 0

    def _reshuffle(self):
        n = len(self.dataset)
        self._order = self._rng.permutation(n) if self.shuffle \
            else np.arange(n)
        self._pos = 0

    def __iter__(self):
        return self

    def next_indices(self) -> np.ndarray:
        """Thread-safe draw of the next global batch; returns this rank's
        rows of its sample indices."""
        with self._idx_lock:
            if self._pos + self.batch_size > len(self._order):
                if self._pos > 0 or len(self._order) == 0:
                    self.epochs_completed += int(len(self._order) > 0)
                    self._reshuffle()
            idx = self._order[self._pos:self._pos + self.batch_size]
            self._pos += self.batch_size
            m = self.batch_size // self.world
            return idx[self.rank * m:(self.rank + 1) * m]

    def seek_batches(self, k: int) -> None:
        """Advance the shuffle state by ``k`` batch draws without
        assembling anything: a stream seeded as a stopped run's and seeked
        by the batches that run drew continues where it would have."""
        for _ in range(k):
            self.next_indices()

    def assemble(self, idx: np.ndarray) -> dict:
        """Build one batch; safe to call from several threads at once."""
        if self._pool is not None:
            samples = list(self._pool.map(self.dataset.__getitem__, idx))
        else:
            samples = [self.dataset[i] for i in idx]
        return collate(samples)

    def __next__(self) -> dict:
        return self.assemble(self.next_indices())

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)


class DevicePrefetcher:
    """Background threads keeping batches of a ``BatchStream`` ahead on
    ``device``.

    Each worker draws indices under the stream's lock, with the draw's
    sequence number, assembles in parallel, and hands over a dict of
    tensors on ``device``; the consumer takes the batches in draw order, so
    that the order does not depend on which worker finishes first (the
    ranks of a data-parallel run must take the same global batch at each
    step).
    """

    def __init__(self, stream: BatchStream, device, *, buffer_size: int = 4,
                 num_workers: int = 1):
        self._it = stream
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        self._q: queue.Queue = queue.Queue(maxsize=max(buffer_size,
                                                       num_workers + 1))
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._error = None
        self._live = num_workers
        self._drawn = 0                 # sequence number of the next draw
        self._next = 0                  # ... of the next batch handed out
        self._ready: dict = {}
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(num_workers)]
        for t in self._threads:
            t.start()

    def _to_device(self, batch: dict, stream):
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in batch.items()}
        if not self._cuda:
            return tensors, None
        with torch.cuda.stream(stream):
            out = {k: v.pin_memory().to(self._device, non_blocking=True)
                   for k, v in tensors.items()}
            done = torch.cuda.Event()
            done.record(stream)
        return out, done

    def _worker(self):
        stream = torch.cuda.Stream(self._device) if self._cuda else None
        try:
            while not self._stop.is_set():
                with self._lock:
                    seq = self._drawn
                    self._drawn += 1
                    idx = self._it.next_indices()
                item = (seq, self._to_device(self._it.assemble(idx), stream))
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surfaced on the next __next__
            self._error = e
        finally:
            with self._lock:
                self._live -= 1
                if self._live == 0:
                    self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while self._next not in self._ready:
            if self._error is not None:   # its draw will never arrive
                raise self._error
            item = self._q.get()
            if item is None:
                if self._error is not None:
                    raise self._error
                raise StopIteration
            self._ready[item[0]] = item[1]
        batch, done = self._ready.pop(self._next)
        self._next += 1
        if done is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            for t in batch.values():
                t.record_stream(consumer)
        return batch

    def close(self):
        self._stop.set()
        # drain, so that workers blocked on a full queue see the stop flag
        for _ in range(3):
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            for t in self._threads:
                t.join(timeout=1.0)
            if not any(t.is_alive() for t in self._threads):
                break
        self._it.close()


def sample_stream(dataset, batch_size: int, *, seed: int = 0,
                  prefetch: bool = True, device="cuda", num_threads: int = 8,
                  num_workers: int = 3, skip_batches: int = 0, rank: int = 0,
                  world: int = 1):
    """An infinite batch stream: numpy batches without ``prefetch``, else
    tensor batches on ``device`` kept ahead by a ``DevicePrefetcher``.
    ``skip_batches`` seeks the shuffle state before any worker draws
    (``BatchStream.seek_batches``); ``rank`` of ``world``: this rank's rows
    of each global batch of ``batch_size``."""
    stream = BatchStream(dataset, batch_size, seed=seed,
                         num_threads=num_threads, rank=rank, world=world)
    if skip_batches:
        stream.seek_batches(skip_batches)
    if not prefetch:
        return stream
    return DevicePrefetcher(stream, device, num_workers=num_workers)
