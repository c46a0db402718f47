"""The plain operations the reference networks are built of."""

from .bias_act import activation_funcs, bias_act
from .conv2d_resample import conv2d_resample
from .filter_design import design_lowpass_filter, filter_size, setup_filter
from .filtered_lrelu import filtered_lrelu
from .modulated_conv import conv2d, modulated_conv2d, modulated_conv2d_resample
from .upfirdn2d import downsample2d, filter2d, gaussian_blur2d, upfirdn2d, upsample2d
