"""Core numerics: sampling, blurring, resampling, gradients, robust penalties.

These are the equivalents of the reference's L1 numerics utilities
(oct_bicubic.cc, oct_binterp.cc, oct_gaussian.cc, oct_zoom.cc,
oct_normalize_geo.cc, include/oct_bc.h) plus the device copies embedded in
oct_variational_optical_flow.cu.  All functions are pure, jit-friendly and
operate on (H, W) or (C, H, W) float32 arrays.
"""

from octane_tpu.core.bc import clamp_shift, mirror_shift
from octane_tpu.core.interp import bicubic_sample, bilinear_sample, catmull_rom_cell
from octane_tpu.core.gaussian import gaussian_kernel_1d, blur_separable, solver_filtsize
from octane_tpu.core.zoom import (
    zoom_size,
    pyramid_downsample,
    zoom_in_flow,
    zoom_out_image,
    zoom_in_image,
)
from octane_tpu.core.gradients import gradient_4th
from octane_tpu.core.psi import psi_deriv
from octane_tpu.core.normalize import band_min_max, normalize_image

__all__ = [
    "clamp_shift", "mirror_shift",
    "bicubic_sample", "bilinear_sample", "catmull_rom_cell",
    "gaussian_kernel_1d", "blur_separable", "solver_filtsize",
    "zoom_size", "pyramid_downsample", "zoom_in_flow", "zoom_out_image",
    "zoom_in_image",
    "gradient_4th", "psi_deriv",
    "band_min_max", "normalize_image",
]
