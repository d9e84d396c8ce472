"""Spatially sharded variational flow.

The per-level solver program is identical to the single-device one -- XLA's
SPMD partitioner localizes every shift/blur/reduction given sharded inputs --
except the flow-dependent warp gather, which is swapped for a shard_map
kernel: each shard pads its block with a +/-``halo``-pixel ppermute halo and
gathers locally.

**Mesh-divisibility padding** (SURVEY section 7 hard part 3): real sector
dims (5424, 21696, odd pyramid levels) rarely divide the mesh, so the global
inputs are edge-replication padded ONCE to a size whose every pyramid level
is mesh-divisible.  All resampling positions, boundary fixups and the linear
system itself follow the TRUE dims (see flow.variational._coarse_to_fine),
padded pixels are decoupled identity rows with exactly-zero CG residuals,
and the output is cropped -- true pixels match the unpadded solve while the
halo warp engages at EVERY level.

**Warp-reach guard**: the halo warp is exact only while max |flow| <=
halo - 2.  Each warp call reduces max |u|,|v| (a cheap psum'd scalar) and
`lax.cond`-falls back to the dense XLA gather (GSPMD collectives, unbounded)
when the bound is exceeded -- displacement is never silently clamped (the
reference has no reach bound, oct_variational_optical_flow.cu:732-745).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from octane_tpu.config import OFConfig
from octane_tpu.core.zoom import zoom_size
from octane_tpu.flow.stencil import warp_bilinear_dense
from octane_tpu.parallel.halo import halo_pad2d
from octane_tpu.parallel.mesh import image_sharding, flow_sharding

_warp_cache = {}


def padded_global_shape(shape, cfg: OFConfig,
                        mesh_shape: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    """Smallest (Hp, Wp) >= shape whose EVERY pyramid level size
    zoom_size(n, scaleF^j) divides the mesh; None if no candidate is found
    (non-standard scale factors -- callers then keep the unpadded shape and
    accept dense-gather levels)."""
    ry, rx = mesh_shape

    def find(n, r):
        factors = [float(np.float32(cfg.scale_factor) ** j)
                   for j in range(cfg.kiters)]
        for cand in range(n, n + r * 2 ** cfg.kiters + r + 1):
            if all(zoom_size(cand, f) % r == 0 for f in factors):
                return cand
        return None

    hp = find(shape[0], ry)
    wp = find(shape[1], rx)
    if hp is None or wp is None:
        return None
    return hp, wp


def make_sharded_warp(mesh, global_hw: Tuple[int, int], halo: int,
                      true_hw: Optional[Tuple[int, int]] = None):
    """Build a warp sampler (same signature as warp_bilinear_dense) that
    samples from a halo-padded local block inside shard_map, guarded by a
    runtime max-|flow| check with a dense-gather fallback.

    Each shard evaluates the reference's globally clamped bilinear gather
    on its own block, with source indices shifted into the halo frame; the
    samples equal warp_bilinear_dense's while max |flow| <= halo - 2.

    ``global_hw`` is the (padded) array shape; ``true_hw`` the true image
    dims used for the reference's conditional position clamps."""
    gh, gw = global_hw
    th, tw = global_hw if true_hw is None else true_hw
    key = (id(mesh), global_hw, (th, tw), halo)
    if key in _warp_cache:
        return _warp_cache[key]
    ry = mesh.shape["dy"]
    rx = mesh.shape["dx"]
    hl, wl = gh // ry, gw // rx
    halo = min(halo, hl, wl)
    if halo < 4:
        # displacement reach (halo - 2) would be degenerate; caller falls
        # back to the dense gather, which GSPMD handles with collectives
        return None
    reach_i = halo - 2
    wp = wl + 2 * halo
    hp2 = hl + 2 * halo

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(None, "dy", "dx"), P("dy", "dx"), P("dy", "dx")),
        out_specs=(P(None, "dy", "dx"), P("dy", "dx"), P("dy", "dx")),
    )
    def halo_warp(fields, u, v):
        gy0 = (lax.axis_index("dy") * hl).astype(jnp.float32)
        gx0 = (lax.axis_index("dx") * wl).astype(jnp.float32)
        ii = gx0 + jnp.arange(wl, dtype=jnp.float32)[None, :]
        jj = gy0 + jnp.arange(hl, dtype=jnp.float32)[:, None]
        px = ii + u
        py = jj + v
        bc_x = (px < 0.0) | (px >= tw)
        bc_y = (py < 0.0) | (py >= th)
        # the reach clamp is a no-op whenever the guard picked this path
        reach = float(reach_i)
        px = ii + jnp.clip(u, -reach, reach)
        py = jj + jnp.clip(v, -reach, reach)
        fpad = halo_pad2d(fields, halo)                 # (K, hl+2h, wl+2h)

        px = jnp.where(px < 0.0, 0.0, jnp.where(px >= tw, float(tw - 1), px))
        py = jnp.where(py < 0.0, 0.0, jnp.where(py >= th, float(th - 1), py))
        iv1 = jnp.minimum(px.astype(jnp.int32), tw - 2)
        jv1 = jnp.minimum(py.astype(jnp.int32), th - 2)
        p1 = (iv1 + 1).astype(jnp.float32) - px
        p2 = px - iv1.astype(jnp.float32)
        p3 = (jv1 + 1).astype(jnp.float32) - py
        p4 = py - jv1.astype(jnp.float32)
        li = jnp.clip(iv1 - gx0.astype(jnp.int32) + halo, 0, wp - 2)
        lj = jnp.clip(jv1 - gy0.astype(jnp.int32) + halo, 0, hp2 - 2)
        k = fpad.shape[0]
        flat = fpad.reshape(k, -1)
        idx = (lj * wp + li).reshape(-1)

        def take(off):
            return jnp.take(flat, idx + off, axis=1).reshape(k, hl, wl)

        f11, f21, f12, f22 = take(0), take(1), take(wp), take(wp + 1)
        samples = p3 * (p1 * f11 + p2 * f21) + p4 * (p1 * f12 + p2 * f22)
        return samples, bc_x, bc_y

    reach = jnp.float32(reach_i)

    def warp(fields, u, v):
        in_reach = ((jnp.max(jnp.abs(u)) <= reach)
                    & (jnp.max(jnp.abs(v)) <= reach))
        return lax.cond(
            in_reach,
            halo_warp,
            lambda f, a, b: warp_bilinear_dense(f, a, b, true_hw=(th, tw)),
            fields, u, v)

    _warp_cache[key] = warp
    return warp


_sharded_program_cache = {}


def sharded_flow_program(cfg: OFConfig, shape, nchan: int, mesh,
                         true_shape=None):
    """One jitted SPMD program for the whole coarse-to-fine solve over the
    mesh (single dispatch; XLA inserts halo collectives for the stencils
    and the shard_map warp handles the gathers).

    ``shape`` is the (mesh-divisible, possibly padded) array shape;
    ``true_shape`` the true image dims (None when equal)."""
    from octane_tpu.flow.variational import _coarse_to_fine

    h, w = shape
    ts = tuple(true_shape) if true_shape is not None else None
    key = (id(mesh), shape, ts, nchan, cfg.alpha, cfg.lambda_, cfg.lambdac,
           cfg.scale_factor, cfg.kiters, cfg.liters, cfg.cgiters,
           cfg.gnc_steps, cfg.dozim, cfg.solver, cfg.sor_omega, cfg.cg_tol,
           cfg.halo_warp)
    if key in _sharded_program_cache:
        return _sharded_program_cache[key]

    th, tw = (h, w) if ts is None else ts
    ry = mesh.shape["dy"]
    rx = mesh.shape["dx"]
    warp_fns = {}
    for k in range(cfg.kiters):
        factor = float(np.float32(cfg.scale_factor) ** (cfg.kiters - k - 1))
        nxx, nyy = zoom_size(w, factor), zoom_size(h, factor)
        lvl_true = (zoom_size(th, factor), zoom_size(tw, factor))
        if nyy % ry == 0 and nxx % rx == 0 and ry * rx > 1:
            wf = make_sharded_warp(mesh, (nyy, nxx), cfg.halo_warp,
                                   true_hw=lvl_true)
            if wf is not None:
                warp_fns[k] = wf

    fsh = flow_sharding(mesh)
    program = jax.jit(
        functools.partial(_coarse_to_fine, cfg=cfg, warp_fns=warp_fns,
                          true_shape=ts),
        out_shardings=(fsh, fsh),
    )
    # structural metadata for dry runs / debugging: which levels compiled
    # the halo-warp shard_map
    program.warp_levels = frozenset(warp_fns)
    global last_program_info
    last_program_info = {"warp_levels": program.warp_levels,
                         "kiters": cfg.kiters}
    _sharded_program_cache[key] = program
    return program


last_program_info = None


def sharded_variational_flow(geo1, geo2, u0, v0, cfg: OFConfig, mesh):
    """Coarse-to-fine variational flow over a ("dy", "dx") device mesh.

    Same level schedule as octane_tpu.flow.variational.variational_flow,
    compiled as one SPMD program with spatially sharded inputs.  Arbitrary
    dims are handled by edge-replication padding to a mesh-divisible shape
    (exact -- see module docstring); the output is cropped back.
    """
    geo1 = jnp.asarray(geo1, jnp.float32)
    geo2 = jnp.asarray(geo2, jnp.float32)
    if geo1.ndim == 2:
        geo1 = geo1[None]
        geo2 = geo2[None]
    u0 = jnp.asarray(u0, jnp.float32)
    v0 = jnp.asarray(v0, jnp.float32)
    h, w = u0.shape

    ry, rx = mesh.shape["dy"], mesh.shape["dx"]
    pad_shape = padded_global_shape((h, w), cfg, (ry, rx))
    true_shape = None
    if pad_shape is not None and pad_shape != (h, w):
        hp, wp = pad_shape
        pw = ((0, hp - h), (0, wp - w))
        geo1 = jnp.pad(geo1, ((0, 0),) + pw, mode="edge")
        geo2 = jnp.pad(geo2, ((0, 0),) + pw, mode="edge")
        u0 = jnp.pad(u0, pw, mode="edge")
        v0 = jnp.pad(v0, pw, mode="edge")
        true_shape = (h, w)

    ish = image_sharding(mesh)
    fsh = flow_sharding(mesh)
    geo1 = jax.device_put(geo1, ish)
    geo2 = jax.device_put(geo2, ish)
    u0 = jax.device_put(u0, fsh)
    v0 = jax.device_put(v0, fsh)
    program = sharded_flow_program(cfg, u0.shape, geo1.shape[0], mesh,
                                   true_shape=true_shape)
    u, v = program(geo1, geo2, u0, v0)
    if true_shape is not None:
        u = u[:h, :w]
        v = v[:h, :w]
    return u, v
