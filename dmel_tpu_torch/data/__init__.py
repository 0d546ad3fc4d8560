"""Datasets, splits and batching of the port (numpy copies of the JAX
package's)."""

from dmel_tpu_torch.data.loader import BatchLoader
from dmel_tpu_torch.data.registry import get_dataset_by_config
from dmel_tpu_torch.data.splits import Subset, random_split
from dmel_tpu_torch.data.synthetic import (GaussPulseDataset,
                                           make_esc50_synth_dataset)

__all__ = ["BatchLoader", "GaussPulseDataset", "Subset",
           "get_dataset_by_config", "make_esc50_synth_dataset",
           "random_split"]
