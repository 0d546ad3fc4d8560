"""Evaluation of the port."""

from dmel_tpu_torch.eval.predict import predict

__all__ = ["predict"]
