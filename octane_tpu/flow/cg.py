"""Jacobi-preconditioned conjugate gradient for the coupled stencil system.

Replaces the reference's in-kernel PCG (oct_variational_optical_flow.cu:
1100-1183): the CSR SpMV becomes the matrix-free stencil apply, the
shared-memory/atomicAdd dot products become jnp reductions (or `lax.psum`
across a device mesh via the injectable ``dot`` argument), and the ~50 grid
barriers per iteration are implicit in XLA dataflow.  Same math: x0 = 0,
r = b, M = diag(A), stop on ||r||^2 <= tol or ``iters`` iterations.

A red-black SOR relaxer is provided as an alternative that needs no global
reductions except for the convergence check.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp


def default_dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, dtype=jnp.float32)


class _PCGState(NamedTuple):
    xu: jnp.ndarray
    xv: jnp.ndarray
    ru: jnp.ndarray
    rv: jnp.ndarray
    zu: jnp.ndarray
    zv: jnp.ndarray
    pu: jnp.ndarray
    pv: jnp.ndarray
    rz: jnp.ndarray
    resid: jnp.ndarray
    k: jnp.ndarray


def pcg_solve(
    apply_fn: Callable,          # (du, dv) -> (Au, Av)
    diag_u: jnp.ndarray,
    diag_v: jnp.ndarray,
    bu: jnp.ndarray,
    bv: jnp.ndarray,
    tol: float,
    iters: int,
    dot: Callable = default_dot,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Solve A x = b from x = 0; returns (du, dv)."""
    minv_u = 1.0 / diag_u
    minv_v = 1.0 / diag_v
    zero = jnp.zeros_like(bu)
    ru, rv = bu, bv
    zu, zv = minv_u * ru, minv_v * rv
    resid0 = dot(ru, ru) + dot(rv, rv)
    rz0 = dot(ru, zu) + dot(rv, zv)
    init = _PCGState(zero, zero, ru, rv, zu, zv, zu, zv,
                     rz0, resid0, jnp.int32(0))

    def cond(s: _PCGState):
        return (s.resid > tol) & (s.k < iters)

    def body(s: _PCGState):
        apu, apv = apply_fn(s.pu, s.pv)
        pap = dot(s.pu, apu) + dot(s.pv, apv)
        alpha = s.rz / pap
        xu = s.xu + alpha * s.pu
        xv = s.xv + alpha * s.pv
        ru = s.ru - alpha * apu
        rv = s.rv - alpha * apv
        resid = dot(ru, ru) + dot(rv, rv)
        zu = minv_u * ru
        zv = minv_v * rv
        rz = dot(ru, zu) + dot(rv, zv)
        beta = rz / s.rz
        pu = zu + beta * s.pu
        pv = zv + beta * s.pv
        return _PCGState(xu, xv, ru, rv, zu, zv, pu, pv, rz, resid, s.k + 1)

    out = jax.lax.while_loop(cond, body, init)
    return out.xu, out.xv


def sor_solve(
    sys,
    tol: float,
    iters: int,
    omega: float = 1.9,
    true_hw=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Red-black SOR on the coupled stencil system (alternative relaxer).

    Each colour update is local given a 1-px halo; the only global
    reduction is the convergence check, which reuses the residual the red
    sweep computes anyway (no extra stencil applies): stop when
    ||b - A x||^2 <= tol -- the same stopping semantics/tolerance as
    ``pcg_solve`` -- or after ``iters`` red+black sweeps.  Converges to
    the same solution as PCG (same SPD system), along a different iterate
    path: parity between the two holds at convergence, not per-iterate
    (tests/test_variational.py runs both to convergence).
    """
    from octane_tpu.flow.stencil import apply_stencil

    h, w = sys.bu.shape
    jj = jnp.arange(h)[:, None]
    ii = jnp.arange(w)[None, :]
    red = ((ii + jj) % 2 == 0)

    # Reciprocal determinant of the local 2x2 block (a1 a2; a2 a4), hoisted
    # out of the sweep loop.  The optimization_barrier wrappers DISCOURAGE
    # (but cannot guarantee: XLA deletes the barrier late in its pipeline,
    # so codegen-level FMA contraction can still differ between separately
    # compiled programs) context-dependent contraction of a1*a4 - a2*a2;
    # two separately compiled programs therefore agree to ulps, not bitwise.
    m1 = jax.lax.optimization_barrier(sys.a1 * sys.a4)
    m2 = jax.lax.optimization_barrier(sys.a2 * sys.a2)
    rdet = jnp.float32(1.0) / (m1 - m2)

    def colour_sweep(du, dv, mask):
        au, av = apply_stencil(sys, du, dv, true_hw=true_hw)
        # Solve the local 2x2 block (a1 a2; a2 a4) exactly for the residual.
        ru = sys.bu - au
        rv = sys.bv - av
        # barrier-wrapped products: best-effort contraction pinning only
        # (XLA deletes the barrier late; see rdet above)
        t1, t2, t3, t4 = jax.lax.optimization_barrier(
            (sys.a4 * ru, sys.a2 * rv, sys.a1 * rv, sys.a2 * ru))
        ndu = (t1 - t2) * rdet
        ndv = (t3 - t4) * rdet
        du = jnp.where(mask, du + omega * ndu, du)
        dv = jnp.where(mask, dv + omega * ndv, dv)
        resid = default_dot(ru, ru) + default_dot(rv, rv)
        return du, dv, resid

    def cond(st):
        return (st[2] > tol) & (st[3] < iters)

    def body(st):
        du, dv, _, k = st
        du, dv, resid = colour_sweep(du, dv, red)
        du, dv, _ = colour_sweep(du, dv, ~red)
        return (du, dv, resid, k + 1)

    zero = jnp.zeros_like(sys.bu)
    resid0 = default_dot(sys.bu, sys.bu) + default_dot(sys.bv, sys.bv)
    du, dv, _, _ = jax.lax.while_loop(
        cond, body, (zero, zero, resid0, jnp.int32(0)))
    return du, dv
