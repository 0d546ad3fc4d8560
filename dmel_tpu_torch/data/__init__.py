"""Datasets, splits, batching and the prefetching host-to-device feed of
the port (numpy copies of the JAX package's datasets)."""

from dmel_tpu_torch.data.audio import (ArrayDataset, audio_mnist_big,
                                       audio_mnist_legacy, esc50, load_wav,
                                       parse_esc50_csv, resample)
from dmel_tpu_torch.data.fsd import fsd50k
from dmel_tpu_torch.data.loader import (BatchLoader, PrefetchIterator,
                                        device_batches)
from dmel_tpu_torch.data.registry import get_dataset_by_config
from dmel_tpu_torch.data.splits import (AUDIO_MNIST_TEST_SPEAKERS,
                                        AUDIO_MNIST_TRAIN_SPEAKERS,
                                        AUDIO_MNIST_VALID_SPEAKERS, Subset,
                                        random_split, random_split_lengths)
from dmel_tpu_torch.data.synthetic import (GaussPulseDataset, fmconst_np,
                                           gauss_pulse_np,
                                           make_esc50_synth_dataset,
                                           make_gauss_pulse_dataset)

__all__ = ["AUDIO_MNIST_TEST_SPEAKERS", "AUDIO_MNIST_TRAIN_SPEAKERS",
           "AUDIO_MNIST_VALID_SPEAKERS", "ArrayDataset", "BatchLoader",
           "GaussPulseDataset", "PrefetchIterator", "Subset",
           "audio_mnist_big", "audio_mnist_legacy", "device_batches",
           "esc50", "fmconst_np", "fsd50k", "gauss_pulse_np",
           "get_dataset_by_config", "load_wav", "make_esc50_synth_dataset",
           "make_gauss_pulse_dataset", "parse_esc50_csv", "random_split",
           "random_split_lengths", "resample"]
