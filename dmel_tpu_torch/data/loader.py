"""Host-side batching (counterpart of ``dmel_tpu/data/loader.py``).

:class:`BatchLoader` is a numpy copy of the JAX package's: whole-epoch
shuffled index slicing into contiguous numpy batches, the ragged tail
padded to the batch size and masked.  Same seed, same orders, batches
and masks; ``set_epoch`` replays the shuffle stream up to an epoch, as a
resumed trial needs.

:class:`PrefetchIterator` runs the slicing and the host-to-device
placement of the next batches on a background thread;
:func:`device_batches` builds that pipeline for a device.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class BatchLoader:
    """Iterates ``(xs, ys, mask)`` numpy batches over an array dataset.

    Args:
      dataset: object with ``.xs`` / ``.ys`` arrays.
      batch_size: batch size.
      shuffle: reshuffle each epoch, from one ``default_rng(seed)``
        stream across epochs.
      seed: shuffle seed.
      pad_last: pad the final ragged batch to ``batch_size`` (repeating
        index 0) and mark the padding False in the mask; if False, the
        ragged batch is yielded as it is.
      drop_last: drop the ragged batch entirely.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, pad_last: bool = True,
                 drop_last: bool = False):
        self.xs = np.asarray(dataset.xs, dtype=np.float32)
        self.ys = np.asarray(dataset.ys)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.pad_last = pad_last
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self):
        n = len(self.xs)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        """Advance the shuffle stream so that the next ``__iter__`` gives
        epoch ``epoch``'s batch order: the permutations of the epochs in
        between are drawn and dropped (the stream is sequential across
        epochs).  An epoch at or before the current one changes
        nothing."""
        scratch = np.arange(len(self.xs))
        for _ in range(max(0, int(epoch) - self._epoch)):
            if self.shuffle:
                self._rng.shuffle(scratch)
            self._epoch += 1

    def __iter__(self):
        n = len(self.xs)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        for start in range(0, n, bs):
            idx = order[start:start + bs]
            if len(idx) < bs:
                if self.drop_last:
                    return
                if self.pad_last:
                    pad = np.zeros(bs - len(idx), dtype=idx.dtype)
                    mask = np.zeros(bs, dtype=bool)
                    mask[:len(idx)] = True
                    idx = np.concatenate([idx, pad])
                    yield self.xs[idx], self.ys[idx], mask
                    continue
            mask = np.ones(len(idx), dtype=bool)
            yield self.xs[idx], self.ys[idx], mask


class PrefetchIterator:
    """Up to ``depth`` items of ``iterable``, each passed through
    ``transform``, made ahead on a background thread.

    An exception of the source or of the transform is raised in the
    consumer at the item where it occurred.  Iteration is single-pass;
    :meth:`close` (also called at the end of the stream) stops the
    worker and drops what it had queued.
    """

    class _Done:
        """End of the stream, carrying the worker's exception if any; a
        type of its own, so that no item can be mistaken for it."""

        def __init__(self, error=None):
            self.error = error

    def __init__(self, iterable, transform=None, depth: int = 2):
        self._q = queue.Queue(maxsize=max(1, int(depth)))
        self._transform = transform
        self._stop = threading.Event()
        self._finished = False

        def put(item):
            # a put that gives up once the consumer closed the iterator,
            # so that an abandoned one does not leave the worker blocked
            # and its batches held
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for item in iterable:
                    if self._stop.is_set():
                        return
                    out = (self._transform(item)
                           if self._transform is not None else item)
                    if not put(out):
                        return
            except BaseException as e:      # noqa: BLE001 - raised in __next__
                put(PrefetchIterator._Done(e))
                return
            put(PrefetchIterator._Done())

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def close(self):
        """Stop the worker and drop the queued items; safe to call more
        than once."""
        self._stop.set()
        self._drain()
        self._thread.join(timeout=1.0)
        # one put can land between the first drain and the worker's stop
        self._drain()

    def __del__(self):                          # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        item = self._q.get()
        if isinstance(item, PrefetchIterator._Done):
            self._finished = True
            self._thread.join()
            if item.error is not None:
                raise item.error
            raise StopIteration
        return item


def device_batches(batches, device: torch.device, prefetch: int = 2):
    """The numpy arrays of each item of ``batches`` (a tuple) as tensors
    on ``device``, made ``prefetch`` items ahead on a background thread
    (:class:`PrefetchIterator`); ``prefetch`` 0 places them in the
    caller's thread.

    On a CUDA device each array is copied into pinned host memory and
    from there with a non-blocking copy made on the stream that is
    current where this function is called, the stream the consumer
    computes on: the copy is ordered before every kernel the consumer
    launches after it, and its memory belongs to that stream.
    """
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)

        def place(batch):
            with torch.cuda.stream(stream):
                return tuple(torch.from_numpy(np.ascontiguousarray(a))
                             .pin_memory().to(device, non_blocking=True)
                             for a in batch)
    else:
        def place(batch):
            return tuple(torch.from_numpy(np.ascontiguousarray(a))
                         .to(device) for a in batch)
    if prefetch > 0:
        return PrefetchIterator(batches, place, depth=prefetch)
    return (place(b) for b in batches)
