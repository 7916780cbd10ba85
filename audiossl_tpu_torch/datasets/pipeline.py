"""Host-side input pipeline: packed records -> padded numpy batches (the
port's own copy of ``audiossl_tpu/datasets/pipeline.py``; the same order
and padding).

The host does only IO and pad/stack; the mel and everything after it run
on the device. A worker thread with a small thread pool prepares batches
ahead, so host IO overlaps device work. An error while loading a record
is raised by the iteration, not swallowed: a split never ends early.

Batches are dicts of numpy arrays with static shapes:
  wav   [B, pad_samples] float32 or int16 (zero-padded)
  valid [B]              int32   valid sample counts
  label [B] / [B, C]     labels (with ``include_labels``)
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Generator, Iterator

import numpy as np

PREFETCH = 2  # batches a loader prepares ahead of its consumer


class _Failed:
    """The worker's exception, carried to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetched(produce: Callable[[], Generator]) -> Iterator:
    """Iterate over the generator ``produce()`` run on a worker thread, at
    most ``PREFETCH`` items ahead of the consumer. The worker's exception
    is raised by the iteration; when the consumer stops early the worker
    stops at its next item and is joined, so no read runs on into the next
    epoch."""
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
    stop = threading.Event()

    def put(item) -> bool:
        # gives up once the consumer has stopped, so no thread is left
        # blocked on a full queue
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        items = produce()
        try:
            for item in items:
                if not put(item):
                    return
            put(None)
        except BaseException as e:  # re-raised by the consumer
            put(_Failed(e))
        finally:
            items.close()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            b = q.get()
            if b is None:
                return
            if isinstance(b, _Failed):
                raise b.exc
            yield b
    finally:
        stop.set()
        t.join(timeout=60)


class BatchLoader:
    """Iterable over padded batches of a map-style dataset.

    dataset must implement __len__ and __getitem__ -> (wav, label).
    drop_last=True gives every batch the same shape. ``shuffle`` draws
    the order from ``np.random.RandomState(seed + epoch)``; with
    ``weights`` (one per record; the reference's ``WeightedRandomSampler``
    for AudioSet finetuning) the same generator draws ``len(dataset)``
    records with replacement, each with probability ``w / w.sum()``,
    shuffled or not. ``num_threads`` records load at once, ``PREFETCH``
    batches are prepared ahead of the consumer.

    ``batch_size`` is the global batch: with ``process_count`` > 1 every
    process draws the same order and reads only its contiguous slice of
    each batch (``batch_size // process_count`` rows from row
    ``process_index`` times that), so the processes' slices together are
    the one-process stream; a batch that does not divide raises.
    """

    def __init__(self, dataset, batch_size: int, pad_samples: int,
                 shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, num_threads: int = 8, epoch: int = 0,
                 include_labels: bool = True, wav_dtype=np.float32,
                 weights=None, process_index: int = 0,
                 process_count: int = 1):
        if batch_size % max(process_count, 1):
            raise ValueError(f"the global batch of {batch_size} does not "
                             f"divide over {process_count} processes")
        self.process_index = process_index
        self.process_count = process_count
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_samples = pad_samples
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_threads = num_threads
        self.epoch = epoch
        self.include_labels = include_labels
        # int16 emit halves host->device batch bytes; dequantized with the
        # same /32768 scale, int16-stored samples are bitwise-identical to
        # the float path. float32-returning datasets are re-quantized to
        # 16 bits (source audio is 16-bit PCM in practice).
        self.wav_dtype = np.dtype(wav_dtype)
        self.weights = None if weights is None else np.asarray(
            weights, np.float64)

    def set_epoch(self, epoch: int):
        """The epoch whose order the next iteration draws."""
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _load_one(self, idx: int):
        wav, label = self.dataset[idx][:2]
        wav = np.asarray(wav, np.float32).reshape(-1)
        n = min(len(wav), self.pad_samples)
        out = np.zeros(self.pad_samples, self.wav_dtype)
        if self.wav_dtype == np.int16:
            out[:n] = np.clip(wav[:n] * 32768.0, -32768, 32767)
        else:
            out[:n] = wav[:n]
        return out, n, label

    def _make_batch(self, pool, indices):
        rows = list(pool.map(self._load_one, indices))
        batch = {"wav": np.stack([r[0] for r in rows]),
                 "valid": np.asarray([r[1] for r in rows], np.int32)}
        if self.include_labels:
            labels = [r[2] for r in rows]
            batch["label"] = (np.stack(labels)
                              if isinstance(labels[0], np.ndarray)
                              else np.asarray(labels))
        return batch

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.weights is not None:
            order = rng.choice(n, size=n, replace=True,
                               p=self.weights / self.weights.sum())
        else:
            order = np.arange(n)
            if self.shuffle:
                rng.shuffle(order)
        chunks = [order[i * self.batch_size:(i + 1) * self.batch_size]
                  for i in range(len(self))]
        if self.process_count > 1:
            local = self.batch_size // self.process_count
            lo = self.process_index * local
            chunks = [c[lo:lo + local] for c in chunks]

        def produce():
            with ThreadPoolExecutor(self.num_threads) as pool:
                for c in chunks:
                    yield self._make_batch(pool, c)

        return prefetched(produce)
