"""4th-order central differences with clamped boundaries.

Equivalent of oct_compgrad_cu
(oct_variational_optical_flow.cu:409-449):

    df/dx = (-f[i+2] + 8 f[i+1] - 8 f[i-1] + f[i-2]) / 12

with each tap index clamped to [0, n-1] (edge replicate).
"""

from __future__ import annotations

import jax.numpy as jnp

from octane_tpu.core.bc import clamp_shift


def gradient_4th(img: jnp.ndarray, true_hw=None):
    """Return (d/dx, d/dy) of a (..., H, W) image.

    ``true_hw`` gives the true (H, W) when ``img`` carries trailing
    mesh-divisibility padding: taps then clamp at the TRUE edge (values at
    padded positions are don't-cares).
    """
    th = tw = None
    if true_hw is not None:
        th, tw = true_hw

    def d(axis, tn):
        return (
            -clamp_shift(img, 2, axis, tn)
            + 8.0 * clamp_shift(img, 1, axis, tn)
            - 8.0 * clamp_shift(img, -1, axis, tn)
            + clamp_shift(img, -2, axis, tn)
        ) / 12.0

    return d(-1, tw), d(-2, th)
