"""Signal-processing ops of the alias-free compute path (``afcm_tpu/ops``).

Plain torch for the elementwise, FIR and conv ops; the fused filtered leaky
ReLU runs kernel K1 (``ops/cuda``, sources in ``csrc/``) on CUDA tensors,
and kernel K2 in its backward; under ``set_conv_impl('int8')`` the gated 3x3
convs run the int8 conv kernel K3 (through K4, its autograd Function).
"""

from .bias_act import activation_funcs, bias_act
from .conv2d_resample import conv2d_resample
from .filter_design import design_lowpass_filter, filter_size, setup_filter
from .filtered_lrelu import filtered_lrelu
from .modulated_conv import (conv2d, get_conv_impl, modulated_conv2d,
                             set_conv_impl)
from .upfirdn2d import gaussian_blur2d, upfirdn2d

__all__ = [
    "activation_funcs", "bias_act", "conv2d", "conv2d_resample",
    "design_lowpass_filter", "filter_size", "filtered_lrelu", "gaussian_blur2d",
    "get_conv_impl", "modulated_conv2d", "set_conv_impl", "setup_filter",
    "upfirdn2d",
]
