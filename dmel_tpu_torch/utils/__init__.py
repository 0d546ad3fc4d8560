"""Utilities of the port: tracing and step timing."""

from dmel_tpu_torch.utils.profiling import StepTimer, trace

__all__ = ["StepTimer", "trace"]
