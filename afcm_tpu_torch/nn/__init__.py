"""Network modules of the port (``afcm_tpu/nn``)."""

from .discriminator import (CoModDiscriminator, DiscriminatorBlock,
                            DiscriminatorEpilogue)
from .layers import (Conv2dLayer, FullyConnected, MinibatchStdLayer,
                     adaptive_avg_pool2d, normalize_2nd_moment)
from .mapping import MappingNetwork
from .stylegan3 import (EncoderLayer, LayerSpec, Stylegan3Generator,
                        SynthesisLayer, SynthesisLayout, SynthesisNetwork,
                        compute_synthesis_layout)

__all__ = [
    "CoModDiscriminator", "Conv2dLayer", "DiscriminatorBlock",
    "DiscriminatorEpilogue", "EncoderLayer", "FullyConnected", "LayerSpec",
    "MappingNetwork", "MinibatchStdLayer", "Stylegan3Generator", "SynthesisLayer",
    "SynthesisLayout", "SynthesisNetwork", "adaptive_avg_pool2d",
    "compute_synthesis_layout", "normalize_2nd_moment",
]
