"""Pixel-displacement <-> wind (m/s) conversion.

Equivalent of oct_pix2uv_cuda.cu: the forward direction navigates
each pixel and its displaced position to lat/lon, then measures independent
zonal and meridional haversine distances divided by the frame interval
(:27-172); the inverse direction advects each pixel's lat/lon along a
great circle by wind*dt and converts back to fixed-grid pixel offsets
(octuv2xy, :222-263 and oct_uv2pix, :372-476).

Behavioural guards replicated: the mesoscale sector-move guard zeroes all
motions when the image-2 grid offsets differ (:295, 358-369); off-earth or
limb (subpoint distance > 0.021 rad^2) pixels get zero winds (:144-147);
short encodings are trunc(100 * value) like the C cast.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax.numpy as jnp

from octane_tpu.nav.goes import _f, goes_latlon, goes_xy_from_latlon
from octane_tpu.nav.polar import polar_latlon
from octane_tpu.nav.mercator import mercator_latlon

DTOR = math.pi / 180.0
EARTH_RADIUS = 6371000.0


def _short100(x):
    """C-style short(100*x) encoding (truncation toward zero)."""
    return jnp.trunc(100.0 * jnp.asarray(x)).astype(jnp.int16)


def haversine_m(lat1, lon1, lat2, lon2):
    """Great-circle distance in metres, inputs in degrees
    (oct_haversine_cuda, oct_pix2uv_cuda.cu:12-25)."""
    rad, rad2 = DTOR, DTOR / 2.0
    dlon = _f(lon2) - _f(lon1)
    dlat = _f(lat2) - _f(lat1)
    a = jnp.sin(dlat * rad2) ** 2 + jnp.cos(_f(lat1) * rad) * jnp.cos(_f(lat2) * rad) * jnp.sin(dlon * rad2) ** 2
    c = 2.0 * jnp.arctan2(jnp.sqrt(a), jnp.sqrt(1.0 - a))
    return EARTH_RADIUS * c


def _sector_moved(nav) -> bool:
    return ((nav.x_offset - nav.g2x_offset) ** 2 >= 1e-5 ** 2
            or (nav.y_offset - nav.g2y_offset) ** 2 >= 1e-5 ** 2)


def _pixel_scan_positions(nav, u_pix, v_pix):
    """Scan coordinates of each pixel and of its displaced end point.

    Matches oct_navpixel_uv_cuda: xi = i + nav.min_x pixel indices scaled by
    (x_scale, x_offset) -- the reference assumes file counts equal pixel
    indices (oct_pix2uv_cuda.cu:192, 40-44).
    """
    h, w = u_pix.shape
    ii = _f(jnp.arange(w))[None, :] + nav.min_x
    jj = _f(jnp.arange(h))[:, None] + nav.min_y
    x0 = ii * nav.x_scale + nav.x_offset
    y0 = jj * nav.y_scale + nav.y_offset
    x1 = (_f(u_pix) + ii) * nav.x_scale + nav.x_offset
    y1 = (_f(v_pix) + jj) * nav.y_scale + nav.y_offset
    return x0, y0, x1, y1


def pix2uv_ms(
    u_pix, v_pix, nav, dt: float, grid: str = "goes",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pixel displacements -> winds in m/s (float; zeros where invalid)."""
    u_pix = jnp.asarray(u_pix)
    v_pix = jnp.asarray(v_pix)
    x0, y0, x1, y1 = _pixel_scan_positions(nav, u_pix, v_pix)
    if grid == "polar":
        lat0, lon0 = polar_latlon(x0, y0, nav)
        lat1, lon1 = polar_latlon(x1, y1, nav)
        limb = jnp.zeros(u_pix.shape, bool)
        bad = jnp.zeros(u_pix.shape, bool)
    elif grid == "mercator":
        lat0, lon0 = mercator_latlon(x0, y0, nav)
        lat1, lon1 = mercator_latlon(x1, y1, nav)
        limb = jnp.zeros(u_pix.shape, bool)
        bad = jnp.zeros(u_pix.shape, bool)
    else:
        lat0, lon0 = goes_latlon(x0, y0, nav, guard=True)
        lat1, lon1 = goes_latlon(x1, y1, nav, guard=True)
        limb = (x0 * x0 + y0 * y0) > 0.021      # sds[0] threshold (:144)
        bad = (lat0 < -998.0) | (lat1 < -998.0)

    invalid = bad | limb
    du = haversine_m(lat0, lon0, lat0, lon1)
    dv = haversine_m(lat0, lon0, lat1, lon0)
    uw = jnp.where(lon1 >= lon0, du, -du) / dt
    vw = jnp.where(lat1 >= lat0, dv, -dv) / dt
    uw = jnp.where(invalid, 0.0, uw)
    vw = jnp.where(invalid, 0.0, vw)
    return uw, vw


def pix2uv(
    u_pix, v_pix, nav, dt: float, grid: str = "goes", pixuv: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pixel displacements -> navigated winds, short-encoded.

    Returns (u_wind_short, v_wind_short, u_raw_short, v_raw_short):
    int16 arrays of 100*m/s and 100*pixels (oct_pix2uv_cuda.cu:265-370).
    """
    u_pix = jnp.asarray(u_pix)
    v_pix = jnp.asarray(v_pix)
    u_raw = _short100(u_pix)
    v_raw = _short100(v_pix)
    if _sector_moved(nav):
        z = jnp.zeros(u_pix.shape, jnp.int16)
        return z, z, z, z
    if pixuv:
        return u_raw, v_raw, u_raw, v_raw
    uw, vw = pix2uv_ms(u_pix, v_pix, nav, dt, grid)
    return _short100(uw), _short100(vw), u_raw, v_raw


def uv2pix(
    u_wind, v_wind, lat, lon, x_counts, y_counts, nav, dt: float,
    grid: str = "goes",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Navigated winds (m/s) -> pixel displacements over ``dt`` seconds.

    Great-circle forward step then fixed-grid forward navigation
    (oct_uv2pix / octuv2xy).  ``lat``/``lon`` are the per-pixel navigation
    arrays; ``x_counts``/``y_counts`` the scan-coordinate counts.  Off-map
    points and moved sectors return zero displacement (weight-to-stationary).
    """
    if _sector_moved(nav):
        z = jnp.zeros(jnp.shape(u_wind), jnp.float32)
        return z, z
    u = _f(u_wind)
    v = _f(v_wind)
    rad = DTOR
    dist = jnp.sqrt(u * u + v * v) * dt
    brng = (180.0 + (90.0 - jnp.arctan2(-v, -u) / rad)) * rad
    lat0 = _f(lat) * rad
    dr = dist / EARTH_RADIUS
    lat_new = jnp.arcsin(jnp.sin(lat0) * jnp.cos(dr)
                         + jnp.cos(lat0) * jnp.sin(dr) * jnp.cos(brng))
    lon_new = _f(lon) * rad + jnp.arctan2(
        jnp.sin(brng) * jnp.sin(dr) * jnp.cos(lat0),
        jnp.cos(dr) - jnp.sin(lat0) * jnp.sin(lat_new),
    )
    xs, ys = goes_xy_from_latlon(lat_new / rad, lon_new / rad, nav)
    x1v = (xs - nav.x_offset) / nav.x_scale
    y1v = (ys - nav.y_offset) / nav.y_scale
    xc = _f(jnp.asarray(x_counts))[None, :]
    yc = _f(jnp.asarray(y_counts))[:, None]
    ok = xs > -998.0
    u_pix = jnp.where(ok, x1v - xc, 0.0).astype(jnp.float32)
    v_pix = jnp.where(ok, y1v - yc, 0.0).astype(jnp.float32)
    return u_pix, v_pix
