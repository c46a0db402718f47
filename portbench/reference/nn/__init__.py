"""The reference networks: the AFCM StyleGAN3 generator, the CoModGAN
generator and the CoModGAN discriminator, in plain PyTorch."""

from .comodgan import CoModGenerator
from .discriminator import CoModDiscriminator
from .stylegan3 import Stylegan3Generator
