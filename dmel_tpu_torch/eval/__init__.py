"""Evaluation of the port: inference over clips, test-set prediction
over a sweep, the multi-label metrics, the paper's tables and the
complexity model."""

from dmel_tpu_torch.eval.complexity import cost_ratio
from dmel_tpu_torch.eval.metrics import (average_precision,
                                         mean_average_precision,
                                         top1_precision)
from dmel_tpu_torch.eval.predict import (predict, predict_test,
                                         predictions_by_row)
from dmel_tpu_torch.eval.tables import (get_model_title,
                                        produce_result_table,
                                        produce_table_1, produce_table_2)

__all__ = ["average_precision", "cost_ratio", "get_model_title",
           "mean_average_precision", "predict", "predict_test",
           "predictions_by_row", "produce_result_table", "produce_table_1",
           "produce_table_2", "top1_precision"]
