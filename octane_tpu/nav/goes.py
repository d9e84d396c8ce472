"""GOES-R ABI fixed-grid navigation and radiance calibration.

Equivalent of oct_navcal_cuda.cu (per-pixel inverse navigation of
scan angles to lat/lon on the GRS80 ellipsoid, Planck / kappa calibration,
limb filtering and normalization) and of the forward navigation in
oct_pix2uv_cuda.cu:222-263.  All functions are elementwise jnp programs --
embarrassingly parallel, XLA fuses them into a single pass.

Everything runs in float64 when x64 is enabled (the reference computes
navigation in double; haversine wind differences of nearby points are
cancellation-sensitive), and degrades to float32 otherwise.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp

DTOR = math.pi / 180.0


def _f(x):
    """Promote to the widest enabled float dtype (f64 when x64 is on)."""
    import jax
    dt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    return jnp.asarray(x, dt)


def goes_latlon(xval, yval, nav, guard: bool = True):
    """Scan angles (rad) -> (lat, lon) degrees.

    GOES-R fixed-grid inverse navigation: ray from the satellite through the
    scan angles intersected with the GRS80 ellipsoid
    (oct_navcal_cuda.cu:36-49; guarded variant oct_pix2uv_cuda.cu:108-140).
    With ``guard=True`` off-earth pixels return -999 fills, otherwise NaN
    (matching the ingest kernel, which has no discriminant check).
    """
    xval = _f(xval)
    yval = _f(yval)
    req = _f(nav.req)
    rpol = _f(nav.rpol)
    h_sat = _f(nav.pph) + req
    sinx, cosx = jnp.sin(xval), jnp.cos(xval)
    siny, cosy = jnp.sin(yval), jnp.cos(yval)
    ratio = (req * req) / (rpol * rpol)
    a = sinx * sinx + cosx * cosx * (cosy * cosy + ratio * siny * siny)
    b = -2.0 * h_sat * cosx * cosy
    c = h_sat * h_sat - req * req
    d = b * b - 4.0 * a * c
    d_safe = jnp.maximum(d, 0.0)
    rs = (-b - jnp.sqrt(d_safe)) / (2.0 * a)
    sx = rs * cosx * cosy
    sy = -rs * sinx
    sz = rs * cosx * siny
    e = (h_sat - sx) ** 2 + sy * sy
    lat = jnp.arctan(ratio * sz / jnp.sqrt(e)) / DTOR
    lon = (_f(nav.lam0) - jnp.arctan2(sy, h_sat - sx)) / DTOR
    if guard:
        bad = (d < 0) | (sz == 0) | (e <= 0)
        lat = jnp.where(bad, -999.0, lat)
        lon = jnp.where(bad, -999.0, lon)
    else:
        nanify = jnp.where(d < 0, jnp.nan, 0.0)
        lat = lat + nanify
        lon = lon + nanify
    return lat, lon


def goes_xy_from_latlon(lat_deg, lon_deg, nav):
    """(lat, lon) degrees -> scan angles (rad); -999 fills off the visible disk.

    Forward navigation, matching octuv2xy (oct_pix2uv_cuda.cu:246-261).
    """
    lat = _f(lat_deg) * DTOR
    lon = _f(lon_deg) * DTOR
    req = _f(nav.req)
    rpol = _f(nav.rpol)
    req2 = req * req
    rpol2 = rpol * rpol
    h_sat = _f(nav.pph) + req
    ecc2 = (req2 - rpol2) / req2          # eval*eval in the reference
    thtc = jnp.arctan((rpol2 / req2) * jnp.tan(lat))
    rc = rpol / jnp.sqrt(1.0 - ecc2 * jnp.cos(thtc) ** 2)
    sx = h_sat - rc * jnp.cos(thtc) * jnp.cos(lon - _f(nav.lam0))
    sy = -rc * jnp.cos(thtc) * jnp.sin(lon - _f(nav.lam0))
    sz = rc * jnp.sin(thtc)
    visible = (h_sat * (h_sat - sx)) >= (sy * sy + (req2 / rpol2) * sz * sz)
    xs = jnp.arcsin(-sy / jnp.sqrt(sx * sx + sy * sy + sz * sz))
    ys = jnp.arctan(sz / sx)
    xs = jnp.where(visible, xs, -999.0)
    ys = jnp.where(visible, ys, -999.0)
    return xs, ys


def planck_temp(rad, fk1, fk2, bc1, bc2):
    """Inverse Planck: radiance -> brightness temperature (K)
    (oct_navcal_cuda.cu:61-65)."""
    rad = _f(rad)
    return (fk2 / jnp.log(fk1 / rad + 1.0) - bc1) / bc2


def kappa_reflectance(rad, kap1):
    """Radiance -> reflectance factor (oct_navcal_cuda.cu:66-70)."""
    return _f(rad) * kap1


def limb_ramp(subpoint_dist2):
    """Limb filter: 1 below 0.021 rad^2, 0 above 0.0212, linear between
    (oct_navcal_cuda.cu:81-92)."""
    slope = 1.0 / (0.021 - 0.0212)
    intercept = 1.0 - 0.021 * slope
    d = _f(subpoint_dist2)
    return jnp.where(
        d < 0.021, 1.0,
        jnp.where(d >= 0.0212, 0.0, slope * d + intercept),
    )


def navcal_goes(
    counts, x_counts, y_counts, nav, channel: int = 0,
    cal: str = "RAW", norm_min: float = 0.0, norm_max: float = 255.0,
    out_min: float = 0.0, out_max: float = 255.0, donav: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Full nav+cal+normalize pass for one GOES channel.

    counts: (H, W) raw integer counts; x_counts/y_counts: (W,)/(H,) scan
    coordinate counts.  Returns (data_norm, lat, lon): the limb-filtered
    image normalized from [norm_min, norm_max] to [out_min, out_max]
    (octnavcalcuda, oct_navcal_cuda.cu:11-98).
    """
    xval = _f(x_counts) * nav.x_scale + nav.x_offset           # (W,)
    yval = _f(y_counts) * nav.y_scale + nav.y_offset           # (H,)
    xg = jnp.broadcast_to(xval[None, :], counts.shape)
    yg = jnp.broadcast_to(yval[:, None], counts.shape)
    sub2 = xg * xg + yg * yg
    dval = _f(counts) * nav.rad_scale[channel] + nav.rad_offset[channel]
    if cal == "TEMP":
        dataf = planck_temp(dval, nav.fk1[channel], nav.fk2[channel],
                            nav.bc1[channel], nav.bc2[channel])
    elif cal == "REF":
        dataf = kappa_reflectance(dval, nav.kap1[channel])
    else:                                   # RAW / BRIT pass radiance through
        dataf = dval
    sds = limb_ramp(sub2)
    data_norm = sds * ((dataf - norm_min) / (norm_max - norm_min)
                       * (out_max - out_min) + out_min)
    if donav:
        lat, lon = goes_latlon(xg, yg, nav, guard=False)
    else:
        lat = jnp.zeros_like(data_norm)
        lon = jnp.zeros_like(data_norm)
    return data_norm, lat, lon
