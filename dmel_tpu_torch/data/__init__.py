"""Datasets of the port (numpy-only copies of the JAX package's)."""

from dmel_tpu_torch.data.synthetic import (GaussPulseDataset,
                                           make_esc50_synth_dataset)

__all__ = ["GaussPulseDataset", "make_esc50_synth_dataset"]
