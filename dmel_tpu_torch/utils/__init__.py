"""Utilities of the port: tracing, step timing and spectrogram
plotting."""

from dmel_tpu_torch.utils.plot import plot_spectrogram
from dmel_tpu_torch.utils.profiling import StepTimer, trace

__all__ = ["StepTimer", "plot_spectrogram", "trace"]
