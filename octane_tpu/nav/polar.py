"""Orthographic polar-grid inverse navigation.

Equivalent of octpolarnavcalcuda (oct_polar_navcal_cuda.cu:11-65):
rho/c great-circle formulas on a sphere of radius ``nav.R`` about the
reference point (nav.lat1, nav.lon0_deg).  No calibration -- polar grids pass
data through (ref :60).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

DTOR = math.pi / 180.0


def polar_latlon(xval, yval, nav, lat1_in_rad_inputs: bool = False):
    """Projected metres (x, y) -> (lat, lon) in degrees.

    ``nav.lat1``/``nav.lon0_deg`` are in degrees; the ingest kernel receives
    them already converted (lat1 in the trig below is radians there, matching
    oct_polar_navcal_cuda.cu:33-53 where lat1/lon0 arrive in radians, and the
    pix2uv variant oct_pix2uv_cuda.cu:34-66 where they arrive in degrees and
    are multiplied by DTOR).  This function always takes degrees.
    """
    from octane_tpu.nav.goes import _f

    xval = _f(xval)
    yval = _f(yval)
    lat1 = _f(nav.lat1) * DTOR
    lon0 = _f(nav.lon0_deg) * DTOR
    r_sphere = _f(nav.R)
    rho = jnp.sqrt(xval * xval + yval * yval)
    c = jnp.arcsin(jnp.clip(rho / r_sphere, -1.0, 1.0))
    pole = nav.lat1 > 89.9999
    if pole:
        lon = lon0 + jnp.arctan2(xval, -yval)
    else:
        lon = lon0 + jnp.arctan2(
            xval * jnp.sin(c),
            rho * jnp.cos(lat1) * jnp.cos(c) - yval * jnp.sin(lat1) * jnp.sin(c),
        )
    lat = jnp.where(
        rho > 1e-7,
        jnp.arcsin(jnp.cos(c) * jnp.sin(lat1)
                   + jnp.where(rho > 1e-7, yval * jnp.sin(c) * jnp.cos(lat1)
                               / jnp.where(rho > 1e-7, rho, 1.0), 0.0)),
        lat1,
    )
    return lat / DTOR, lon / DTOR
