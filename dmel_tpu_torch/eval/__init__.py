"""Evaluation of the port: inference over clips, test-set prediction
over a sweep, the multi-label metrics, the paper's tables and figures,
and the complexity model.  The figures import matplotlib only when they
draw."""

from dmel_tpu_torch.eval.complexity import cost_ratio, produce_complexity_plot
from dmel_tpu_torch.eval.figures import (ACC_BANDS, produce_accuracy_plot,
                                         produce_data_example_plot)
from dmel_tpu_torch.eval.metrics import (average_precision,
                                         mean_average_precision,
                                         top1_precision)
from dmel_tpu_torch.eval.predict import (predict, predict_test,
                                         predictions_by_row)
from dmel_tpu_torch.eval.tables import (get_model_title,
                                        produce_result_table,
                                        produce_table_1, produce_table_2)

__all__ = ["ACC_BANDS", "average_precision", "cost_ratio", "get_model_title",
           "mean_average_precision", "predict", "predict_test",
           "predictions_by_row", "produce_accuracy_plot",
           "produce_complexity_plot", "produce_data_example_plot",
           "produce_result_table", "produce_table_1", "produce_table_2",
           "top1_precision"]
