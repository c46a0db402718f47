"""ctypes bindings for the native host-side data ops (with numpy fallback)."""

from .build import get_native, have_native
from .ops import (accumulate_patches, assemble_windows, err_stats,
                  slice_metrics, ssim_mean)

__all__ = ["accumulate_patches", "assemble_windows", "get_native",
           "have_native", "ssim_mean", "err_stats", "slice_metrics"]
