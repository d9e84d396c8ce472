"""Flow computation orchestration.

Equivalent of oct_optical_flow.cc: prepares the first guess
(zeros, or navigated first-guess winds converted to pixel displacements),
dispatches to the variational or patch-match engine, converts cloud-top
heights to the short CTP product, navigates pixel displacements to winds,
and optionally applies the bilateral smoother.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from octane_tpu.config import OFConfig
from octane_tpu.io.datamodel import Scene
from octane_tpu.flow.variational import variational_flow
from octane_tpu.flow.patch_match import patch_match_flow
from octane_tpu.nav.winds import pix2uv, pix2uv_ms, uv2pix
from octane_tpu.post.srsal import srsal_smooth


def active_mesh(cfg: OFConfig):
    """The (dy, dx) device mesh when cfg.mesh_shape requests one and enough
    devices exist; None for the single-device path."""
    import jax
    ry, rx = cfg.mesh_shape
    if ry * rx > 1 and len(jax.devices()) >= ry * rx:
        from octane_tpu.parallel.mesh import make_mesh
        return make_mesh((ry, rx))
    return None


def _variational(data1, data2, u0, v0, cfg: OFConfig, mesh=None):
    """Dense solve, spatially sharded when cfg.mesh_shape requests it."""
    if mesh is not None:
        from octane_tpu.parallel.sharded import sharded_variational_flow
        return sharded_variational_flow(data1, data2, u0, v0, cfg, mesh)
    return variational_flow(data1, data2, u0, v0, cfg)


def compute_flow(scene1: Scene, scene2: Scene, cfg: OFConfig,
                 first_guess=None) -> Scene:
    """Fill scene1's flow products from the (scene1, scene2) image pair.

    Mirrors oct_optical_flow (oct_optical_flow.cc:21-111); returns scene1
    (fields filled in place on the dataclass).  ``first_guess`` optionally
    supplies (u0, v0) pixel displacements directly (sequence warm starts),
    bypassing the navigated-winds conversion.
    """
    h, w = scene1.shape
    nav = scene1.nav
    dt = scene2.t - scene1.t

    # --- first guess (ref :37-53) -------------------------------------------
    have_guess = True
    if first_guess is not None:
        u0 = jnp.asarray(first_guess[0], jnp.float32)
        v0 = jnp.asarray(first_guess[1], jnp.float32)
    elif cfg.do_firstguess and scene1.ufg is not None:
        u0, v0 = uv2pix(
            scene1.ufg, scene1.vfg, scene1.lat, scene1.lon,
            scene1.x, scene1.y, nav, dt, grid=cfg.grid,
        )
    else:
        have_guess = False
        u0 = jnp.zeros((h, w), jnp.float32)
        v0 = jnp.zeros((h, w), jnp.float32)

    # --- flow engine (ref :54-68; "hybrid" = BASELINE config 4:
    # patch-match initialization + variational refinement) -------------------
    mesh = active_mesh(cfg)
    if cfg.algorithm in ("patch_match", "hybrid"):
        if scene1.nchannels > 1 and cfg.algorithm == "patch_match":
            raise ValueError("patch match supports single-channel input only")
        if not have_guess and mesh is not None:
            from octane_tpu.flow.patch_match import patch_match_flow_sharded
            u, v = patch_match_flow_sharded(
                scene1.data[0], scene2.data[0], mesh, cfg.rad, cfg.srad)
        elif not have_guess:
            # slice-based fast path (no per-pixel gathers)
            u, v = patch_match_flow(
                scene1.data[0], scene2.data[0], None, None, cfg.rad, cfg.srad)
        else:
            u, v = patch_match_flow(
                scene1.data[0], scene2.data[0], u0, v0, cfg.rad, cfg.srad)
        if cfg.algorithm == "hybrid":
            u, v = _variational(scene1.data, scene2.data, u, v, cfg, mesh)
    else:
        u, v = _variational(scene1.data, scene2.data, u0, v0, cfg, mesh)

    scene1.u_pix = np.asarray(u)
    scene1.v_pix = np.asarray(v)

    # --- CTP product (ref :71-88) -------------------------------------------
    if cfg.do_cth and scene1.cth is not None:
        cthv = np.asarray(scene1.cth)
        if cfg.ir:
            scene1.ctp = ((cthv - 300.0) * 100.0).astype(np.int16)
        else:
            scene1.ctp = cthv.astype(np.int16)

    # --- navigate to winds (ref :91), mesh-sharded when one is active -------
    nav.g2x_offset = scene2.nav.x_offset if cfg.grid == "goes" else nav.x_offset
    nav.g2y_offset = scene2.nav.y_offset if cfg.grid == "goes" else nav.y_offset
    if mesh is not None:
        from octane_tpu.parallel.post import sharded_pix2uv, sharded_pix2uv_ms
        uw, vw, ur, vr = sharded_pix2uv(u, v, nav, dt, mesh,
                                        grid=cfg.grid, pixuv=cfg.pixuv)
    else:
        uw, vw, ur, vr = pix2uv(u, v, nav, dt, grid=cfg.grid, pixuv=cfg.pixuv)
    scene1.u_wind = np.asarray(uw)
    scene1.v_wind = np.asarray(vw)
    scene1.u_raw = np.asarray(ur)
    scene1.v_raw = np.asarray(vr)
    if cfg.grid != "goes" and not cfg.pixuv:
        # flat-grid products keep full-precision winds (oct_polarwrite writes
        # U/V as doubles, oct_filewrite.cc:401-402)
        if mesh is not None:
            ums, vms = sharded_pix2uv_ms(u, v, nav, dt, mesh, grid=cfg.grid)
        else:
            ums, vms = pix2uv_ms(u, v, nav, dt, grid=cfg.grid)
        scene1.u_ms = np.asarray(ums, np.float64)
        scene1.v_ms = np.asarray(vms, np.float64)
    scene1.dt = float(dt)

    # --- optional anisotropic smoothing (ref :100-105) ----------------------
    if cfg.do_srsal and scene1.cth is not None:
        if mesh is not None:
            from octane_tpu.parallel.post import sharded_srsal
            us, vs = sharded_srsal(u, v, jnp.asarray(scene1.cth), mesh)
        else:
            us, vs = srsal_smooth(u, v, scene1.cth)
        scene1.u_pix = np.asarray(us)
        scene1.v_pix = np.asarray(vs)

    return scene1
