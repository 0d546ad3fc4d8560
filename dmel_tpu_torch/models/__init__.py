"""Models of the port: the DMEL front end (single- and multi-sigma), the
DSPEC front end, the seven probe classifiers, MelPANNsNet (CNN6), and
the PANNs Cnn14 and attention head, which no registry name builds (as
in the JAX package)."""

from dmel_tpu_torch.models.classifiers import (BatchNormLinearNet, ConvNet,
                                               LinearNet, MelConvNet,
                                               MelLinearNet, MelMlpNet,
                                               MelPANNsNet, MlpNet)
from dmel_tpu_torch.models.layers import (MelSpectrogramLayer,
                                          MultiSigmaMelSpectrogramLayer,
                                          SpectrogramLayer)
from dmel_tpu_torch.models.panns import (AttBlock, Cnn6, Cnn14, ConvBlock,
                                        ConvBlock5x5)
from dmel_tpu_torch.models.registry import (dispatch_hint_for,
                                            get_model_by_config,
                                            n_classes_for)

__all__ = ["AttBlock", "BatchNormLinearNet", "Cnn6", "Cnn14", "ConvBlock",
           "ConvBlock5x5", "ConvNet", "LinearNet", "MelConvNet",
           "MelLinearNet", "MelMlpNet", "MelPANNsNet", "MelSpectrogramLayer",
           "MlpNet",
           "MultiSigmaMelSpectrogramLayer", "SpectrogramLayer",
           "dispatch_hint_for", "get_model_by_config", "n_classes_for"]
