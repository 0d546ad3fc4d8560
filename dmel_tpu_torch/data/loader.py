"""Host-side batching (a numpy copy of ``BatchLoader`` from
``dmel_tpu/data/loader.py``): whole-epoch shuffled index slicing into
contiguous numpy batches, the ragged tail padded to the batch size and
masked.  Same seed, same orders, batches and masks.
"""

from __future__ import annotations

import numpy as np


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

    def __len__(self):
        n = len(self.xs)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.xs)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
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
