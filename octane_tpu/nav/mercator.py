"""Spherical Mercator inverse navigation.

Equivalent of octmercnavcalcuda (oct_merc_navcal_cuda.cu:11-49):
lon = x/R + lon0, lat = pi/2 - 2*atan(exp(-y/R)), on a sphere of radius
``nav.R``.  ``nav.lon1`` is the reference longitude in radians (as in the
reference's GOESNAVVar.lon1 usage at oct_pix2uv_cuda.cu:83-86).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

DTOR = math.pi / 180.0


def mercator_latlon(xval, yval, nav):
    """Projected metres (x, y) -> (lat, lon) in degrees."""
    from octane_tpu.nav.goes import _f

    xval = _f(xval)
    yval = _f(yval)
    r_sphere = _f(nav.R)
    lon = xval / r_sphere + _f(nav.lon1)
    lat = math.pi / 2.0 - 2.0 * jnp.arctan(jnp.exp(-yval / r_sphere))
    return lat / DTOR, lon / DTOR
