"""Seeded train/valid/test splits (a copy of ``random_split`` and its
helpers from ``dmel_tpu/data/splits.py``): torch's ``randperm`` under a
seeded generator and ``torch.utils.data.random_split``'s length
rounding, so split membership matches the JAX package and the original
PyTorch code bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


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
