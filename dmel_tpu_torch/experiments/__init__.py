"""Experiment orchestration of the port: search spaces, the sweep
runner and its CLI (``python -m dmel_tpu_torch.experiments.cli``)."""

from dmel_tpu_torch.experiments.configs import (audio_mnist, esc50,
                                                esc50_synth, expand_grid,
                                                fsd, get_search_space,
                                                grid_search, time_frequency)
from dmel_tpu_torch.experiments.runner import (collect_results,
                                               get_config_by_row,
                                               load_results, run_sweep,
                                               run_sweep_packed, run_trial,
                                               trial_dirname)

__all__ = ["audio_mnist", "collect_results", "esc50", "esc50_synth",
           "expand_grid", "fsd", "get_config_by_row", "get_search_space",
           "grid_search", "load_results", "run_sweep", "run_sweep_packed",
           "run_trial", "time_frequency", "trial_dirname"]
