"""dmel_tpu_torch: the differentiable log-mel spectrogram framework in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``dmel_tpu`` (JAX on TPU), module for module: ``ops``
(windows, filterbanks, STFT, DMEL and the specband, framed and fused
kernels), ``models`` (the DMEL and DSPEC front ends, the probe
classifiers and MelPANNsNet), ``data`` (AudioMNIST, ESC-50 and the
synthetic datasets, splits, batching and the prefetching feed),
``training`` (``fit``, per-group optimizers), ``parallel``
(data parallelism over a mesh of ranks, and ``fit_trials``: a sweep's
trials packed into one program), ``eval``
(prediction, the paper's tables and figures, the complexity model),
``utils`` (tracing, step timing, spectrogram plotting), ``convert``
(weights from the JAX package) and ``precision`` (the numeric settings
of ``fit`` and ``predict``).  It imports neither JAX nor the JAX package.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from dmel_tpu_torch.convert import from_jax_variables
from dmel_tpu_torch.eval.predict import predict
from dmel_tpu_torch.models.registry import get_model_by_config
from dmel_tpu_torch.ops.dmel import (log_mel_spectrogram, mel_spectrogram,
                                     multi_sigma_mel_spectrogram)
from dmel_tpu_torch.ops.mel import melscale_fbanks
from dmel_tpu_torch.ops.spectrogram import (next_power_of_2,
                                            optimized_window_length,
                                            spectrogram)
from dmel_tpu_torch.ops.window import (gaussian_window,
                                       translated_gaussian_window)
from dmel_tpu_torch.precision import precision_scope
from dmel_tpu_torch.training import build_optimizer, fit

__all__ = ["build_optimizer", "fit", "from_jax_variables", "gaussian_window",
           "get_model_by_config", "log_mel_spectrogram", "mel_spectrogram",
           "melscale_fbanks", "multi_sigma_mel_spectrogram",
           "next_power_of_2", "optimized_window_length", "precision_scope",
           "predict", "spectrogram", "translated_gaussian_window"]
