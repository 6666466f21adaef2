"""Prefetching host loader producing stacked micro-batch arrays.

A thread pool decodes ahead of the device; each ``next()`` yields the whole
step's batch dict ``{'d_real', 'd_enc', 'g_imgs'}`` (plus ``'g_real'`` for
the dual contrastive loss), each stacked as (accum, B, H, W, C) uint8, which
the train step moves to the device and divides by 255 there. Also
class-balanced sampling weights. The same code as the JAX package's
``data/loader.py`` (numpy only), kept as the port's own copy.

A rank of a data-parallel group passes ``shard``: it draws the same global
index order as every other rank and decodes only its slice of each
micro-batch for training.

Each take from the prefetch queue is a ``train.data_wait`` span of
:mod:`stylex_tpu_torch.utils.tracing`, counted in ``loader.blocked`` where
the queue was empty.
"""

from __future__ import annotations

import queue
import random as pyrandom
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np

from stylex_tpu_torch.utils import tracing

__all__ = ["StepBatchLoader", "balanced_class_weights", "SampleLoader", "as_float01"]


def as_float01(batch: np.ndarray) -> np.ndarray:
    """Undo the loader's uint8 transfer quantization (no-op for float)."""
    if batch.dtype == np.uint8:
        return batch.astype(np.float32) / 255.0
    return batch


def balanced_class_weights(labels: Sequence[int], num_classes: int) -> np.ndarray:
    """Inverse-frequency weights for class-rebalanced sampling."""
    labels = np.asarray(labels)
    counts = np.bincount(labels, minlength=num_classes).astype(np.float64)
    per_class = len(labels) / np.maximum(counts, 1)
    return per_class[labels]


class SampleLoader:
    """Infinite shuffled sample stream with threaded decode-ahead.

    ``quantize=True`` ships batches as uint8 (images are 8-bit at rest) and
    the train step normalises them on the device: a quarter of float32's
    host-to-device bytes.

    ``shard``: the rows of each batch that the producer decodes ahead.
    :meth:`next_shard` returns them; ``next()`` returns the whole batch,
    decoding the other rows when it is called. Either takes the next batch
    of the one index stream (``pulled`` counts them; :meth:`skip` drops
    some), so ranks that take the same number of batches stay in step.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0, num_workers: int = 8,
                 weights: Optional[np.ndarray] = None, prefetch: int = 4,
                 quantize: bool = True, shard: Optional[slice] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shard = slice(None) if shard is None else shard
        self.pulled = 0
        self.rng = np.random.RandomState(seed)
        self.weights = None
        if weights is not None:
            w = np.asarray(weights, np.float64)
            self.weights = w / w.sum()
        self.quantize = quantize
        self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.queue: "queue.Queue[tuple]" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _draw_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.weights is not None:
            return self.rng.choice(n, size=self.batch_size, p=self.weights)
        return self.rng.randint(0, n, size=self.batch_size)

    def _submit(self, indices) -> list:
        return [self.pool.submit(self.dataset.__getitem__, int(i)) for i in indices]

    def _decode(self, futures) -> np.ndarray:
        batch = np.stack([f.result() for f in futures]).astype(np.float32)
        if self.quantize:
            batch = np.clip(batch * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)
        return batch

    def _producer(self):
        while not self._stop.is_set():
            idx = self._draw_indices()
            try:
                futures = self._submit(idx[self.shard])
            except RuntimeError:
                # close() shut the pool down between the stop-flag check and
                # the submit; just exit the producer
                return
            item = (idx, self._decode(futures))
            # wait for room rather than drop the batch: the stream must not
            # depend on how long the consumer took (ranks stay in step)
            while not self._stop.is_set():
                try:
                    self.queue.put(item, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def _take(self) -> tuple:
        """The next queued (indices, rows), waiting for the producer where
        the queue is empty."""
        self.pulled += 1
        with tracing.span("train.data_wait"):
            try:
                return self.queue.get_nowait()
            except queue.Empty:
                tracing.count("loader.blocked")
                return self.queue.get()

    def next_shard(self) -> np.ndarray:
        """The next batch's ``shard`` rows."""
        return self._take()[1]

    def __next__(self) -> np.ndarray:
        """The next batch, whole."""
        idx, part = self._take()
        lo, hi, _ = self.shard.indices(len(idx))
        if (lo, hi) == (0, len(idx)):
            return part
        rest = self._decode(self._submit(np.concatenate([idx[:lo], idx[hi:]])))
        return np.concatenate([rest[:lo], part, rest[lo:]])

    def skip(self, n: int) -> None:
        """Drop the next ``n`` batches."""
        for _ in range(n):
            self.next_shard()

    def close(self):
        self._stop.set()
        # unblock a producer stuck in queue.put, then let it observe the
        # stop flag and exit BEFORE the pool goes away (it can enqueue at
        # most one more batch after the drain)
        try:
            while True:
                self.queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        self.pool.shutdown(wait=False)


class StepBatchLoader:
    """Yields the full train-step batch dict: the D phase's real and
    encoder batches and the G phase's images, each ``accum`` micro-batches
    stacked."""

    def __init__(self, dataset, batch_size: int, accum: int, seed: int = 0,
                 num_workers: int = 8, weights: Optional[np.ndarray] = None,
                 need_g_real: bool = False, shard: Optional[slice] = None):
        self.accum = accum
        self.need_g_real = need_g_real
        self.sample_loader = SampleLoader(
            dataset, batch_size, seed=seed, num_workers=num_workers, weights=weights,
            prefetch=2 * (3 + int(need_g_real)) * accum, shard=shard,
        )

    def _stack(self, n: int) -> np.ndarray:
        return np.stack([self.sample_loader.next_shard() for _ in range(n)])

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = {
            "d_real": self._stack(self.accum),
            "d_enc": self._stack(self.accum),
            "g_imgs": self._stack(self.accum),
        }
        if self.need_g_real:
            batch["g_real"] = self._stack(self.accum)
        return batch

    def close(self):
        self.sample_loader.close()
