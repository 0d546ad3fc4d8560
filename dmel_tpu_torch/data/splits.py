"""Train/valid/test splits (a copy of ``dmel_tpu/data/splits.py``).

- AudioMNIST: the fixed 36/12/12 speaker partition, with its
  disjointness and coverage check;
- the other datasets: a seeded ``random_split`` (torch's ``randperm``
  under a seeded generator and ``torch.utils.data.random_split``'s
  length rounding), so split membership matches the JAX package and the
  original PyTorch code bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

#: the AudioMNIST speaker IDs of each split (data constants)
AUDIO_MNIST_TRAIN_SPEAKERS = [28, 56, 7, 19, 35, 1, 6, 16, 23, 34, 46, 53,
                              36, 57, 9, 24, 37, 2, 8, 17, 29, 39, 48, 54,
                              43, 58, 14, 25, 38, 3, 10, 20, 30, 40, 49, 55]
AUDIO_MNIST_VALID_SPEAKERS = [12, 47, 59, 15, 27, 41, 4, 11, 21, 31, 44, 50]
AUDIO_MNIST_TEST_SPEAKERS = [26, 52, 60, 18, 32, 42, 5, 13, 22, 33, 45, 51]


def check_speaker_partition():
    """The three speaker lists are disjoint and cover the 60 speakers."""
    all_ids = (AUDIO_MNIST_TRAIN_SPEAKERS + AUDIO_MNIST_VALID_SPEAKERS
               + AUDIO_MNIST_TEST_SPEAKERS)
    assert len(all_ids) == 60
    assert len(set(all_ids)) == 60


def random_split_lengths(n: int, fractions) -> list[int]:
    """torch.utils.data.random_split fractional-lengths rounding:
    floor each fraction, then distribute the remainder one by one in
    round-robin order."""
    lengths = [int(np.floor(n * f)) for f in fractions]
    remainder = n - sum(lengths)
    for i in range(remainder):
        lengths[i % len(lengths)] += 1
    return lengths


def torch_seeded_permutation(n: int, seed: int = 0) -> np.ndarray:
    """The permutation ``torch.randperm`` gives under
    ``Generator().manual_seed(seed)``."""
    g = torch.Generator()
    g.manual_seed(seed)
    return torch.randperm(n, generator=g).numpy()


class Subset:
    """View of a dataset at fixed indices (torch Subset equivalent)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    @property
    def xs(self):
        return np.asarray(self.dataset.xs)[self.indices]

    @property
    def ys(self):
        return np.asarray(self.dataset.ys)[self.indices]


def random_split(dataset, fractions=(0.7, 0.1, 0.2), seed: int = 0):
    """Seeded split of ``dataset`` into ``Subset``s of the given
    fractions."""
    n = len(dataset)
    perm = torch_seeded_permutation(n, seed)
    lengths = random_split_lengths(n, fractions)
    out, ofs = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + ln]))
        ofs += ln
    return tuple(out)
