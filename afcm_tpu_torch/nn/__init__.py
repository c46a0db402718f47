"""Network modules of the port (``afcm_tpu/nn``)."""

from .comodgan import (CoModGenerator, CoModSynthesisNetwork, RefMappingNetwork,
                       get_synthesizer)
from .discriminator import (CoModDiscriminator, DiscriminatorBlock,
                            DiscriminatorEpilogue)
from .layers import (CALayer, Conv2dLayer, FullyConnected, MinibatchStdLayer,
                     adaptive_avg_pool2d, normalize_2nd_moment)
from .mapping import MappingNetwork
from .motion import (MotionMappingNetwork, MotionSynthesisNetwork,
                     StyleGANVDiscriminator, StyleGANVGenerator)
from .pix2pix import NLayerDiscriminator, PixelDiscriminator, UnetGenerator
from .stylegan3 import (EncoderLayer, LayerSpec, Stylegan3Generator,
                        SynthesisInput, SynthesisLayer, SynthesisLayout,
                        SynthesisNetwork, compute_synthesis_layout)

__all__ = [
    "CALayer", "CoModDiscriminator", "CoModGenerator", "CoModSynthesisNetwork",
    "Conv2dLayer", "DiscriminatorBlock",
    "DiscriminatorEpilogue", "EncoderLayer", "FullyConnected", "LayerSpec",
    "MappingNetwork", "MinibatchStdLayer", "MotionMappingNetwork",
    "MotionSynthesisNetwork", "NLayerDiscriminator", "PixelDiscriminator",
    "RefMappingNetwork", "StyleGANVDiscriminator", "StyleGANVGenerator",
    "Stylegan3Generator", "SynthesisInput", "SynthesisLayer", "SynthesisLayout",
    "SynthesisNetwork",
    "UnetGenerator", "adaptive_avg_pool2d",
    "compute_synthesis_layout", "get_synthesizer", "normalize_2nd_moment",
]
