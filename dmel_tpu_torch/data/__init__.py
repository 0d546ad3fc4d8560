"""Datasets, splits, batching and the prefetching host-to-device feed of
the port (numpy copies of the JAX package's datasets)."""

from dmel_tpu_torch.data.audio import ArrayDataset
from dmel_tpu_torch.data.fsd import fsd50k
from dmel_tpu_torch.data.loader import (BatchLoader, PrefetchIterator,
                                        device_batches)
from dmel_tpu_torch.data.registry import get_dataset_by_config
from dmel_tpu_torch.data.splits import Subset, random_split
from dmel_tpu_torch.data.synthetic import (GaussPulseDataset,
                                           make_esc50_synth_dataset,
                                           make_gauss_pulse_dataset)

__all__ = ["ArrayDataset", "BatchLoader", "GaussPulseDataset",
           "PrefetchIterator", "Subset", "device_batches", "fsd50k",
           "get_dataset_by_config", "make_esc50_synth_dataset",
           "make_gauss_pulse_dataset", "random_split"]
