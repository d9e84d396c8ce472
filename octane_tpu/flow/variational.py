"""Coarse-to-fine variational optical flow (modified Zimmer / Brox).

A redesign of the reference's cooperative-groups mega-kernel
(oct_variational_optical_flow.cu:468-1211) as one XLA program per pair.
The pyramid is a Python loop over levels unrolled at trace time (each
level has its own static shapes); graduated non-convexity and the relinearization iterations run
inside the jit as a `lax.fori_loop`; the PCG solve is a `lax.while_loop`
with the same stopping rule (||r||^2 <= 1e-8, <= cgiters iterations).

Numerics replicated exactly (see SURVEY.md section 8): per-level images are
blurred-then-floor-subsampled from full resolution, first-guess "hat" fields
are downsampled the same way and scaled by the level factor, flow upsampling
is half-pixel bicubic divided by the scale factor, and the hinting weight
decays as lambdac * 0.5^k (oct_variational_optical_flow.cu:487-575,493).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp

from octane_tpu.config import OFConfig
from octane_tpu.core.gradients import gradient_4th
from octane_tpu.core.zoom import pyramid_downsample, zoom_in_flow, zoom_size
from octane_tpu.flow.stencil import assemble, apply_stencil
from octane_tpu.flow.cg import pcg_solve, sor_solve


@functools.partial(
    jax.jit,
    static_argnames=("liters", "cgiters", "gnc_steps", "dozim", "solver",
                     "warp_fn", "true_hw", "sor_omega"),
)
def solve_level(
    g1, g2, u, v, uhat, vhat,
    alpha, lam_over_alpha, lambdac, tol,
    liters: int, cgiters: int, gnc_steps: int, dozim: bool, solver: str = "pcg",
    warp_fn=None, true_hw=None, sor_omega: float = 1.9,
):
    """Run GNC x inner iterations at one pyramid level.

    g1/g2: (C, H, W) level images; u/v: initial flow; uhat/vhat: first-guess
    hint fields at this level.  Returns the updated (u, v).

    ``true_hw``: the true level dims when the arrays carry trailing
    mesh-divisibility padding (sharded path).  All boundary handling then
    happens at the true edges and padded pixels are decoupled identity rows,
    so true-pixel results match the unpadded solve.
    """
    gx1, gy1 = gradient_4th(g1, true_hw)
    gx2, gy2 = gradient_4th(g2, true_hw)
    gxx, _ = gradient_4th(gx2, true_hw)
    gxy, gyy = gradient_4th(gy2, true_hw)  # Ixy = d/dx (d/dy geo2), ref :591-594
    # the warp-sample stack is loop-invariant: build it once per level
    stack = jnp.concatenate([g2, gx2, gy2, gxx, gxy, gyy], axis=0)

    def make_inner(al1, al1_s):
        def inner(uv):
            u, v = uv
            sys = assemble(
                g1, g2, gx1, gy1, gx2, gy2, gxx, gxy, gyy,
                u, v, uhat, vhat, al1, alpha, lam_over_alpha, lambdac,
                dozim, warp_fn=warp_fn, stack=stack, al1_static=al1_s,
                true_hw=true_hw,
            )
            if solver == "sor":
                du, dv = sor_solve(sys, tol, cgiters, omega=sor_omega,
                                   true_hw=true_hw)
            else:
                du, dv = pcg_solve(
                    lambda a, b: apply_stencil(sys, a, b, true_hw=true_hw),
                    sys.a1, sys.a4, sys.bu, sys.bv, tol, cgiters,
                )
            return u + du, v + dv

        return inner

    # Two traced bodies per level, not gnc_steps: the quadratic first step
    # (al1 == 1 at trace time) skips the robust-smoothness block and reads
    # scalar off-diagonals in its CG (see assemble's al1_static); all
    # remaining GNC steps share one fori_loop body with al1 = 1 - 0.5*g
    # computed from the loop index (their traces are otherwise identical).
    quad = make_inner(jnp.float32(1.0), 1.0)
    u, v = jax.lax.fori_loop(0, liters, lambda _, uv: quad(uv), (u, v))
    if gnc_steps > 1:
        def robust(i, uv):
            g = 1.0 + (i // liters).astype(jnp.float32)
            return make_inner(1.0 - 0.5 * g, None)(uv)
        u, v = jax.lax.fori_loop(0, (gnc_steps - 1) * liters, robust, (u, v))
    return u, v


def _coarse_to_fine(geo1, geo2, u0, v0, cfg: OFConfig, warp_fns=None,
                    true_shape=None):
    """Trace the full pyramid schedule (shapes static, loop unrolled).

    ``warp_fns`` optionally maps level index -> warp sampler (the sharded
    halo-exchange path).  ``true_shape`` gives the true (H, W) when
    the inputs carry trailing mesh-divisibility padding (padded with edge
    replication); level sizes, resampling positions and boundary handling
    then follow the TRUE dims, so true pixels match the unpadded schedule
    and the returned padded flow only needs cropping.
    """
    h, w = u0.shape
    th, tw = (h, w) if true_shape is None else true_shape
    padded = (th, tw) != (h, w)
    kiters = cfg.kiters
    u = v = None
    prev_true = None
    for k in range(kiters):
        factor = float(np.float32(cfg.scale_factor) ** (kiters - k - 1))
        nxx, nyy = zoom_size(w, factor), zoom_size(h, factor)
        tnx, tny = zoom_size(tw, factor), zoom_size(th, factor)
        lambdac_k = (cfg.lambdac / cfg.alpha) * (0.5 ** k)
        true_in = (th, tw) if padded else None

        if k == kiters - 1:
            g1, g2 = geo1, geo2
            uhat, vhat = u0, v0
        else:
            g1 = pyramid_downsample(geo1, factor, true_in)
            g2 = pyramid_downsample(geo2, factor, true_in)
            uhat = pyramid_downsample(u0, factor, true_in) * jnp.float32(factor)
            vhat = pyramid_downsample(v0, factor, true_in) * jnp.float32(factor)

        if k == 0:
            u, v = uhat, vhat
        else:
            zi = prev_true if padded else None
            zo = (tny, tnx) if padded else None
            u = zoom_in_flow(u, (nyy, nxx), cfg.scale_factor, zi, zo)
            v = zoom_in_flow(v, (nyy, nxx), cfg.scale_factor, zi, zo)

        u, v = solve_level(
            g1, g2, u, v, uhat, vhat,
            jnp.float32(cfg.alpha), jnp.float32(cfg.lambda_over_alpha),
            jnp.float32(lambdac_k), jnp.float32(cfg.cg_tol),
            cfg.liters, cfg.cgiters, cfg.gnc_steps, cfg.dozim, cfg.solver,
            warp_fn=warp_fns.get(k) if warp_fns else None,
            true_hw=(tny, tnx) if padded else None,
            sor_omega=cfg.sor_omega,
        )
        prev_true = (tny, tnx)
    return u, v


_program_cache = {}


def flow_program(cfg: OFConfig, shape, nchan: int):
    """One jitted program for the ENTIRE coarse-to-fine solve.

    A single dispatch per image pair: the level loop is unrolled at trace
    time, so pyramid construction, warping, assembly and all CG iterations
    compile into one XLA executable (no per-level host round trips -- this
    is what makes the solver latency-tolerant in production serving).
    """
    key = (shape, nchan, cfg.alpha, cfg.lambda_, cfg.lambdac, cfg.scale_factor,
           cfg.kiters, cfg.liters, cfg.cgiters, cfg.gnc_steps, cfg.dozim,
           cfg.solver, cfg.sor_omega, cfg.cg_tol)
    if key in _program_cache:
        return _program_cache[key]

    @jax.jit
    def program(geo1, geo2, u0, v0):
        return _coarse_to_fine(geo1, geo2, u0, v0, cfg)

    _program_cache[key] = program
    return program


def variational_flow(
    geo1: jnp.ndarray,
    geo2: jnp.ndarray,
    u0: jnp.ndarray,
    v0: jnp.ndarray,
    cfg: OFConfig,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full coarse-to-fine solve.

    geo1/geo2: (C, H, W) float32 images normalized to [0, 255];
    u0/v0: (H, W) float32 first-guess pixel displacements (zeros if none).
    Returns (u, v) dense pixel displacements at full resolution.
    """
    geo1 = jnp.asarray(geo1, jnp.float32)
    geo2 = jnp.asarray(geo2, jnp.float32)
    if geo1.ndim == 2:
        geo1 = geo1[None]
        geo2 = geo2[None]
    u0 = jnp.asarray(u0, jnp.float32)
    v0 = jnp.asarray(v0, jnp.float32)
    program = flow_program(cfg, u0.shape, geo1.shape[0])
    return program(geo1, geo2, u0, v0)
