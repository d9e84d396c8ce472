"""File ingest: GOES-R L1b, polar/mercator grids, CLAVR-x CTH, first guess.

Equivalent of oct_fileread.cc.  GOES-R L1b "netCDF4" files are
HDF5 containers, so ingest is built on h5py (no libnetcdf dependency in this
image); variables and attributes are read by the same names the reference
uses (oct_fileread.cc:99-263).  Navigation + calibration + normalization run
as one jitted elementwise pass on device (octane_tpu.nav.goes.navcal_goes).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import jax.numpy as jnp

try:
    import h5py
except ImportError:                                    # pragma: no cover
    h5py = None

from octane_tpu.config import OFConfig
from octane_tpu.core.normalize import band_min_max
from octane_tpu.core.zoom import (zoom_in_image, zoom_out_image,
                                  zoom_in_image_rows, zoom_out_image_rows)
from octane_tpu.io.datamodel import NavConstants, Scene
from octane_tpu.nav.goes import navcal_goes

DTOR = math.pi / 180.0


def _require_h5py():
    if h5py is None:
        raise RuntimeError("h5py is required for file ingest")


def _scalar(ds):
    v = np.asarray(ds[()])
    return v.reshape(-1)[0] if v.ndim else v.item() if hasattr(v, "item") else v


def _attr(var, name):
    v = var.attrs[name]
    if isinstance(v, bytes):
        return v.decode()
    arr = np.asarray(v).reshape(-1)
    if arr.dtype.kind in "SU":
        s = arr[0]
        return s.decode() if isinstance(s, bytes) else str(s)
    return arr[0]


def _tuple_set(tup, idx, val):
    lst = list(tup)
    lst[idx] = float(val)
    return tuple(lst)


def read_scene(
    path: str,
    cfg: OFConfig,
    donav: bool = True,
    channel: int = 1,
    scene: Optional[Scene] = None,
    row_range: Optional[tuple] = None,
) -> Scene:
    """Read one GOES-R L1b file into a Scene (oct_goesread, oct_fileread.cc:43-419).

    ``channel`` 1 reads the primary grid and navigation; channels 2/3 read
    auxiliary bands and regrid them onto the channel-1 grid.

    ``row_range`` (r0, r1) restricts ingest to a row block (hyperslab read +
    block nav/cal) for host-sharded multi-process ingest; the returned
    Scene's arrays cover only those rows while nav keeps the global dims.
    """
    _require_h5py()
    if cfg.grid != "goes":
        return _read_flat_grid(path, cfg, donav, scene, row_range)

    with h5py.File(path, "r") as f:
        rad = f["Rad"]
        x = np.asarray(f["x"][()], np.int16)
        y_full = np.asarray(f["y"][()], np.int16)
        band = int(_scalar(f["band_id"]))
        h_full, w_full = rad.shape
        defer_block = row_range is not None and channel != 1
        if row_range is not None and channel == 1:
            r0, r1 = row_range
            counts = np.asarray(rad[r0:r1, :], np.int16)
            y = y_full[r0:r1]
        elif defer_block:
            # channels 2/3 live on their own grid: the block read happens
            # inside the margin-extended regrid below (target-row driven)
            counts = None
            y = y_full
        else:
            counts = np.asarray(rad[()], np.int16)
            y = y_full
        h, w = h_full, w_full

        ci = channel - 1
        if scene is None:
            nav = NavConstants(grid="goes")
        else:
            nav = scene.nav
        nav.rad_scale = _tuple_set(nav.rad_scale, ci, _attr(rad, "scale_factor"))
        nav.rad_offset = _tuple_set(nav.rad_offset, ci, _attr(rad, "add_offset"))
        nav.fk1 = _tuple_set(nav.fk1, ci, _scalar(f["planck_fk1"]))
        nav.fk2 = _tuple_set(nav.fk2, ci, _scalar(f["planck_fk2"]))
        nav.bc1 = _tuple_set(nav.bc1, ci, _scalar(f["planck_bc1"]))
        nav.bc2 = _tuple_set(nav.bc2, ci, _scalar(f["planck_bc2"]))
        nav.kap1 = _tuple_set(nav.kap1, ci, _scalar(f["kappa0"]))

        if channel == 1:
            nav.x_scale = float(_attr(f["x"], "scale_factor"))
            nav.x_offset = float(_attr(f["x"], "add_offset"))
            nav.y_scale = float(_attr(f["y"], "scale_factor"))
            nav.y_offset = float(_attr(f["y"], "add_offset"))
            gip = f["goes_imager_projection"]
            nav.gip_val = float(_scalar(gip))
            nav.lpo = float(_attr(gip, "longitude_of_projection_origin"))
            nav.req = float(_attr(gip, "semi_major_axis"))
            nav.rpol = float(_attr(gip, "semi_minor_axis"))
            nav.inverse_flattening = float(_attr(gip, "inverse_flattening"))
            nav.lat0 = float(_attr(gip, "latitude_of_projection_origin"))
            nav.pph = float(_attr(gip, "perspective_point_height"))
            nav.lam0 = nav.lpo * DTOR
            nav.nx, nav.ny = w, h
            nav.min_x = nav.min_y = 0
            nav.max_x, nav.max_y = w, h
            # CLAVR-x coordinate subsetting factors (oct_fileread.cc:315-336)
            div = 4 if band == 2 else (2 if band in (1, 3) else 1)
            nav.min_xc, nav.min_yc = 0, 0
            nav.max_xc, nav.max_yc = w // div, h // div
            t = float(_scalar(f["t"]))
            t_units = _attr(f["t"], "units")
        else:
            t = scene.t
            t_units = scene.t_units

        # normalization range (band table unless overridden; oct_fileread.cc:341-359)
        vmin, vmax = band_min_max(band)
        omin = getattr(cfg, "norm_min" if channel == 1 else f"norm_min{channel}")
        omax = getattr(cfg, "norm_max" if channel == 1 else f"norm_max{channel}")
        vmin = omin if omin is not None else vmin
        vmax = omax if omax is not None else vmax

        norm_used = (float(vmin), float(vmax))
        if not defer_block:
            data, lat, lon = navcal_goes(
                jnp.asarray(counts), jnp.asarray(x), jnp.asarray(y), nav,
                channel=ci, cal="RAW", norm_min=vmin, norm_max=vmax,
                donav=donav and channel == 1,
            )
            data = np.asarray(data, np.float32)

    if channel == 1:
        sc = scene if scene is not None else Scene(nav=nav, data=np.zeros((0, 0, 0)))
        sc.nav = nav
        sc.data = data[None]
        sc.t = t
        sc.t_units = t_units
        sc.band = _tuple_set(sc.band if sc.band else (0, 0, 0), 0, band)
        sc.x = x
        sc.y = y
        sc.raw_counts = counts[None]
        sc.norm_ranges = (norm_used,) + tuple(sc.norm_ranges[1:])
        if donav:
            sc.lat = np.asarray(lat)
            sc.lon = np.asarray(lon)
        return sc

    # channels 2/3: regrid to channel-1 grid (oct_fileread.cc:361-380)
    assert scene is not None, "channel 1 must be read first"
    h1, w1 = scene.nav.ny, scene.nav.nx
    if defer_block:
        # host-sharded ingest: the regrid block is driven by the TARGET row
        # range; read_cal_rows hyperslab-reads + calibrates only the
        # margin-extended source rows (exact vs the full regrid)
        def read_cal_rows(s0, s1):
            with h5py.File(path, "r") as f2:
                cblk = np.asarray(f2["Rad"][s0:s1, :], np.int16)
            d, _, _ = navcal_goes(
                jnp.asarray(cblk), jnp.asarray(x),
                jnp.asarray(y_full[s0:s1]), nav, channel=ci, cal="RAW",
                norm_min=vmin, norm_max=vmax, donav=False)
            return np.asarray(d, np.float32)

        if w1 > w:
            regridded = np.asarray(zoom_in_image_rows(
                read_cal_rows, h, w, (h1, w1), row_range, True))
        elif w1 == w:
            regridded = read_cal_rows(*row_range)
        else:
            regridded = np.asarray(zoom_out_image_rows(
                read_cal_rows, h, w, w1 / w, row_range))
    elif w1 > w:
        regridded = np.asarray(zoom_in_image(jnp.asarray(data), (h1, w1), True))
    elif w1 == w:
        regridded = data
    else:
        factor = w1 / w
        regridded = np.asarray(zoom_out_image(jnp.asarray(data), factor))
    scene.data = np.concatenate([scene.data, regridded[None]], axis=0)
    scene.band = _tuple_set(scene.band, channel - 1, band)
    nr = list(scene.norm_ranges)
    nr[channel - 1] = norm_used
    scene.norm_ranges = tuple(nr)
    if scene.raw_counts is not None and scene.raw_counts.shape[0] < channel:
        # pseudo-counts on the channel-1 grid (the reference stores original-
        # resolution counts against channel-1 dims, which cannot round-trip;
        # we invert the normalization instead)
        from octane_tpu.io.native import requantize
        cnt = requantize(regridded, norm_used[0], norm_used[1],
                         nav.rad_scale[ci], nav.rad_offset[ci])
        scene.raw_counts = np.concatenate([scene.raw_counts, cnt[None]], axis=0)
    return scene


def _read_flat_grid(path, cfg, donav, scene, row_range=None):
    """Polar / mercator grid ingest (oct_polarread, oct_fileread.cc:421-610;
    oct_mercread, :611-754).

    File format per the reference: float "Rad" data, int16 x/y with
    scale/offset attrs (projected metres), a "grid_mapping" scalar variable
    carrying lat1/lon0/R (polar, degrees) or lon1/R (mercator, degrees --
    converted to radians on ingest like oct_merc_navcal_cuda.cu:45), and "t"
    with a units attr.  Data passes through uncalibrated (ref polar :60).

    ``row_range`` restricts ingest to a row block (host-sharded
    multi-process ingest); nav keeps the global dims.
    """
    _require_h5py()
    with h5py.File(path, "r") as f:
        ds = f["Rad"]
        h_full, w_full = ds.shape
        x = np.asarray(f["x"][()], np.int16)
        y = np.asarray(f["y"][()], np.int16)
        if row_range is not None:
            r0, r1 = row_range
            data = np.asarray(ds[r0:r1, :], np.float32)
            y = y[r0:r1]
        else:
            data = np.asarray(ds[()], np.float32)
        nav = NavConstants(grid=cfg.grid)
        nav.x_scale = float(_attr(f["x"], "scale_factor"))
        nav.x_offset = float(_attr(f["x"], "add_offset"))
        nav.y_scale = float(_attr(f["y"], "scale_factor"))
        nav.y_offset = float(_attr(f["y"], "add_offset"))
        gm = f["grid_mapping"]
        nav.R = float(_attr(gm, "R"))
        if cfg.grid == "polar":
            nav.lat1 = float(_attr(gm, "lat1"))
            nav.lon0_deg = float(_attr(gm, "lon0"))
        else:
            nav.lon1 = float(_attr(gm, "lon1")) * DTOR
        nav.ny, nav.nx = h_full, w_full
        nav.max_x, nav.max_y = nav.nx, nav.ny
        nav.max_xc, nav.max_yc = nav.nx, nav.ny
        t = float(_scalar(f["t"]))
        t_units = _attr(f["t"], "units") if "units" in f["t"].attrs else ""
    sc = Scene(nav=nav, data=data[None], t=t, t_units=t_units)
    sc.x = x
    sc.y = y
    sc.raw_counts = data[None].astype(np.float32)  # flat grids keep float data
    if donav:
        from octane_tpu.nav.polar import polar_latlon
        from octane_tpu.nav.mercator import mercator_latlon
        xv = x.astype(np.float64) * nav.x_scale + nav.x_offset
        yv = y.astype(np.float64) * nav.y_scale + nav.y_offset
        xg, yg = np.meshgrid(xv, yv)
        fn = polar_latlon if cfg.grid == "polar" else mercator_latlon
        lat, lon = fn(jnp.asarray(xg), jnp.asarray(yg), nav)
        sc.lat = np.asarray(lat)
        sc.lon = np.asarray(lon)
    return sc


def read_cth(path: str, scene: Scene, cfg: OFConfig,
             row_range: Optional[tuple] = None) -> Scene:
    """CLAVR-x cloud-top height ingest + regrid (oct_clavrxread,
    oct_fileread.cc:756-816).  ``row_range`` restricts the regridded CTH to
    a TARGET row block (margin-extended hyperslab source reads)."""
    _require_h5py()
    with h5py.File(path, "r") as f:
        ds = f["Cloud_Top_Height_Effective"]
        hs, ws = ds.shape
        cth = None if row_range is not None else np.asarray(ds[()], np.float32)
    xs = scene.nav.max_xc - scene.nav.min_xc
    scene.nav.cth_nx = xs
    scene.nav.cth_ny = scene.nav.max_yc - scene.nav.min_yc
    h1, w1 = scene.nav.ny, scene.nav.nx
    if row_range is not None:
        def read_rows(s0, s1):
            with h5py.File(path, "r") as f2:
                return np.asarray(
                    f2["Cloud_Top_Height_Effective"][s0:s1, :], np.float32)

        if w1 > xs:
            scene.cth = np.asarray(zoom_in_image_rows(
                read_rows, hs, ws, (h1, w1), row_range,
                cfg.interp_cth_bicubic))
        elif w1 == xs:
            scene.cth = read_rows(*row_range)
        else:
            scene.cth = np.asarray(zoom_out_image_rows(
                read_rows, hs, ws, w1 / xs, row_range))
        return scene
    if w1 > xs:
        scene.cth = np.asarray(
            zoom_in_image(jnp.asarray(cth), (h1, w1), cfg.interp_cth_bicubic))
    elif w1 == xs:
        scene.cth = cth
    else:
        scene.cth = np.asarray(zoom_out_image(jnp.asarray(cth), w1 / xs))
    return scene


def read_first_guess(path: str, scene: Scene,
                     row_range: Optional[tuple] = None) -> Scene:
    """First-guess winds ingest (oct_fgread, oct_fileread.cc:817-868):
    UFG/VFG are navigated winds in m/s on the image grid.  ``row_range``
    hyperslab-reads only that row block."""
    _require_h5py()
    sl = slice(None) if row_range is None else slice(*row_range)
    with h5py.File(path, "r") as f:
        scene.ufg = np.asarray(f["UFG"][sl, :], np.float32)
        scene.vfg = np.asarray(f["VFG"][sl, :], np.float32)
    return scene
