"""Evaluation of the port: inference over clips, test-set prediction
over a sweep, and the multi-label metrics."""

from dmel_tpu_torch.eval.metrics import (average_precision,
                                         mean_average_precision,
                                         top1_precision)
from dmel_tpu_torch.eval.predict import (predict, predict_test,
                                         predictions_by_row)

__all__ = ["average_precision", "mean_average_precision", "predict",
           "predict_test", "predictions_by_row", "top1_precision"]
