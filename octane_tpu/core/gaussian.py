"""Gaussian kernel generation and separable blur.

Equivalent of oct_gaussian.cc:34-104 and the on-device copies
fill_GK/convh/convv in oct_variational_optical_flow.cu:206-351.

Two reference quirks are replicated deliberately:

* the kernel has 2*filtsize+1 taps and is normalized over ALL of them, but
  the convolutions only apply taps -filtsize .. filtsize-1 (the ``< filtsize``
  loop bound at oct_variational_optical_flow.cu:322,344 and
  oct_gaussian.cc:70,91), so the blur is slightly asymmetric and its taps sum
  to a bit less than 1;
* boundary handling is clamp-to-edge (oct_bc), not true reflection.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from octane_tpu.core.bc import clamp_shift


def solver_filtsize(factor: float) -> int:
    """Per-level filter half-width used inside the solver.

    sigma = 1/sqrt(2*factor), filtsize = trunc(2*sigma), min 5
    (oct_variational_optical_flow.cu:521-526).
    """
    sigma = 1.0 / math.sqrt(2.0 * factor)
    return max(int(2.0 * sigma), 5)


def ingest_filtsize(sigma: float) -> int:
    """Filter half-width for the CPU/ingest blur: trunc(2*sigma), min 5
    (oct_gaussian.cc:54-56)."""
    return max(int(2.0 * sigma), 5)


def gaussian_kernel_1d(sigma: float, filtsize: int) -> np.ndarray:
    """2*filtsize+1 tap kernel, exp(-x^2/2s^2)/(pi*2s^2), sum-normalized.

    Matches oct_getGaussian_1D (oct_gaussian.cc:34-48) / fill_GK
    (oct_variational_optical_flow.cu:206-228).
    """
    s = 2.0 * sigma * sigma
    x = np.arange(-filtsize, filtsize + 1, dtype=np.float64)
    k = np.exp(-(x * x) / s) / (math.pi * s)
    k = k / k.sum()
    return k.astype(np.float32)


def blur_separable(img: jnp.ndarray, kernel: np.ndarray, filtsize: int) -> jnp.ndarray:
    """Separable clamp-edge blur with the reference's asymmetric tap range.

    Applies taps k in [-filtsize, filtsize) horizontally then vertically
    (convh then convv, oct_variational_optical_flow.cu:310-351).  ``img`` is
    (..., H, W); the kernel is a length 2*filtsize+1 numpy array (static).
    """
    kernel = np.asarray(kernel, np.float32)

    def conv_axis(a, axis):
        out = None
        for off in range(-filtsize, filtsize):         # note: excludes +filtsize
            wgt = float(kernel[off + filtsize])
            term = clamp_shift(a, off, axis) * wgt
            out = term if out is None else out + term
        return out

    out = conv_axis(img, -1)     # horizontal (x)
    out = conv_axis(out, -2)     # vertical (y)
    return out
