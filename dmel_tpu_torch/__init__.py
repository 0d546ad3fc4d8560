"""dmel_tpu_torch: the differentiable log-mel spectrogram framework in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The port of ``dmel_tpu`` (JAX on TPU), module for module: ``ops``
(windows, filterbanks, STFT, DMEL and the specband kernels),
``models`` (the DMEL front end and MelPANNsNet), ``data`` (the
esc50_synth dataset, splits, batching), ``training`` (``fit``,
per-group optimizers), ``eval`` and ``convert`` (weights from the JAX
package).  It imports neither JAX nor the JAX package.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

from dmel_tpu_torch.convert import from_jax_variables
from dmel_tpu_torch.eval.predict import predict
from dmel_tpu_torch.models.registry import get_model_by_config
from dmel_tpu_torch.ops.dmel import log_mel_spectrogram, mel_spectrogram
from dmel_tpu_torch.training import build_optimizer, fit

__all__ = ["build_optimizer", "fit", "from_jax_variables",
           "get_model_by_config", "log_mel_spectrogram", "mel_spectrogram",
           "predict"]
