"""Models of the port: the DMEL front end and MelPANNsNet (CNN6)."""

from dmel_tpu_torch.models.classifiers import MelPANNsNet
from dmel_tpu_torch.models.layers import MelSpectrogramLayer
from dmel_tpu_torch.models.panns import Cnn6, ConvBlock5x5
from dmel_tpu_torch.models.registry import (dispatch_hint_for,
                                            get_model_by_config,
                                            n_classes_for)

__all__ = ["Cnn6", "ConvBlock5x5", "MelPANNsNet", "MelSpectrogramLayer",
           "dispatch_hint_for", "get_model_by_config", "n_classes_for"]
