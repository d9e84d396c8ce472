"""Euler-Lagrange system assembly and the matrix-free coupled 5-point stencil.

The reference assembles a 2N x 2N CSR matrix whose u-row for pixel (i, j) is

    [ a6 @ (i, j-1) | a5 @ (i-1, j) | a1 @ diag | a2 @ dv | a7 @ (i+1, j) | a8 @ (i, j+1) ]

(and symmetrically for v with a4 on the diagonal) with mirror-at-1 boundary
folding -- at an edge the out-of-range neighbour coefficient is added onto the
opposite interior neighbour (oct_variational_optical_flow.cu:868-1077).
Here the same operator is applied matrix-free: the coefficients live in seven
(H, W) fields and the SpMV is six shifted multiply-adds, which fuses into one
elementwise pass, moves fewer bytes than CSR, and shards cleanly with halo
exchange.

``assemble`` reproduces the data/smoothness-term math of the assembly loop
(oct_variational_optical_flow.cu:611-1097) exactly: bilinear warping with
clamped positions (warped gradients zeroed where the warp clamped), Zimmer
normalization, graduated non-convexity blending and the lagged-diffusivity
smoothness weights.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from octane_tpu.core.bc import mirror_shift
from octane_tpu.core.psi import psi_deriv


class StencilSystem(NamedTuple):
    """Coefficient fields of the coupled 5-point system A w = b."""

    a1: jnp.ndarray   # u-diagonal
    a2: jnp.ndarray   # u<->v coupling (symmetric)
    a4: jnp.ndarray   # v-diagonal
    a5: jnp.ndarray   # west  (i-1, j)
    a6: jnp.ndarray   # north (i, j-1)
    a7: jnp.ndarray   # east  (i+1, j)
    a8: jnp.ndarray   # south (i, j+1)
    bu: jnp.ndarray   # rhs, u equation
    bv: jnp.ndarray   # rhs, v equation


def apply_stencil(sys: StencilSystem, du: jnp.ndarray, dv: jnp.ndarray,
                  true_hw=None):
    """Matrix-free A @ (du, dv) with mirror-at-1 boundary handling.

    ``true_hw`` places the mirror fixups at the TRUE edges when the fields
    carry trailing mesh-divisibility padding (padded rows are decoupled
    identity equations -- see ``assemble``).
    """
    th, tw = (None, None) if true_hw is None else true_hw

    def op(f):
        return (
            sys.a5 * mirror_shift(f, -1, -1, tw)
            + sys.a7 * mirror_shift(f, 1, -1, tw)
            + sys.a6 * mirror_shift(f, -1, -2, th)
            + sys.a8 * mirror_shift(f, 1, -2, th)
        )

    au = sys.a1 * du + sys.a2 * dv + op(du)
    av = sys.a2 * du + sys.a4 * dv + op(dv)
    return au, av


def _sq(x):
    return x * x


def _bilinear_coefs(u, v, h, w, stride_w=None):
    """Warp positions + bilinear coefficients with the solver's clamping.

    Returns (idx00, p1, p2, p3, p4, bc_x, bc_y) where idx00 is the flat index
    of the cell origin and bc_x/bc_y flag positions that were clamped
    (oct_variational_optical_flow.cu:727-758).  ``h``/``w`` are the TRUE
    image dims (clamping bounds); the output grid and the flat-index row
    stride may be larger when the arrays carry trailing padding.
    """
    gh, gw = u.shape
    sw = w if stride_w is None else stride_w
    ii = jnp.arange(gw, dtype=jnp.float32)[None, :]
    jj = jnp.arange(gh, dtype=jnp.float32)[:, None]
    px = ii + u
    py = jj + v
    bc_x = (px < 0.0) | (px >= w)
    bc_y = (py < 0.0) | (py >= h)
    # oct_bc_cu sets x = nx-1 only when x >= nx; values in (nx-1, nx) pass
    # through unchanged (oct_variational_optical_flow.cu:26-41).
    iv = jnp.where(px < 0.0, 0.0, jnp.where(px >= w, float(w - 1), px))
    jv = jnp.where(py < 0.0, 0.0, jnp.where(py >= h, float(h - 1), py))
    iv1 = jnp.minimum(iv.astype(jnp.int32), w - 2)
    jv1 = jnp.minimum(jv.astype(jnp.int32), h - 2)
    p1 = (iv1 + 1).astype(jnp.float32) - iv
    p2 = iv - iv1.astype(jnp.float32)
    p3 = (jv1 + 1).astype(jnp.float32) - jv
    p4 = jv - jv1.astype(jnp.float32)
    idx00 = jv1 * sw + iv1
    return idx00, p1, p2, p3, p4, bc_x, bc_y


def warp_bilinear_dense(fields: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray,
                        true_hw=None):
    """Bilinear-sample a (K, H, W) stack at (i+u, j+v) with solver clamping.

    Returns (samples (K, H, W), bc_x, bc_y).  This is the single-device
    sampler; octane_tpu.parallel.sharded provides a halo-exchange variant
    with the same signature for spatially sharded grids.  ``true_hw`` gives
    the true dims when the stack carries trailing padding (samples clamp to
    the true region; padded output pixels are don't-cares).
    """
    k, h, w = fields.shape
    th, tw = (h, w) if true_hw is None else true_hw
    idx00, p1, p2, p3, p4, bc_x, bc_y = _bilinear_coefs(
        u, v, th, tw, stride_w=w)
    flat = fields.reshape(k, -1)
    idx = idx00.reshape(-1)

    def take(off):
        return jnp.take(flat, idx + off, axis=1).reshape(k, h, w)

    f11, f21, f12, f22 = take(0), take(1), take(w), take(w + 1)
    samples = p3 * (p1 * f11 + p2 * f21) + p4 * (p1 * f12 + p2 * f22)
    return samples, bc_x, bc_y


def assemble(
    geo1, geo2, gx1, gy1, gx2, gy2, gxx, gxy, gyy,
    u, v, uhat, vhat,
    al1, alpha, lam_over_alpha, lambdac, dozim: bool,
    warp_fn=None, stack=None, al1_static=None, true_hw=None,
) -> StencilSystem:
    """Build the linearized Euler-Lagrange system around the current (u, v).

    Arguments are (C, H, W) image/gradient stacks and (H, W) flow fields.
    ``al1`` is the graduated-non-convexity blend (1, 0.5, 0 over the three
    GNC steps); ``lambdac`` is the per-level hinting weight (already divided
    by alpha and decayed 0.5^k).  ``warp_fn`` overrides the bilinear warp
    sampler (used by the sharded halo-exchange path).

    ``al1_static``, when given, is the Python-float value of ``al1`` known
    at trace time.  The fully-quadratic GNC step (al1 == 1) then skips the
    entire robust-smoothness block -- its psi terms are multiplied by
    (1 - al1) == 0 -- and emits the four off-diagonal stencil coefficients
    as the scalar constant -1, which removes four (H, W) field reads from
    every CG iteration of that step.  The emitted system matches the
    dynamic-al1 path elementwise (x + 0*y == x for finite y, up to the
    IEEE signed-zero exception -0.0 + 0.0 == +0.0, which cannot surface
    here: the diagonals include the strictly positive +4.0/psistot terms,
    and equality of the full products is confirmed empirically by the
    golden regression fixture).
    """
    c_, h, w = geo1.shape
    th, tw = (h, w) if true_hw is None else true_hw
    f32 = jnp.float32
    al1 = jnp.asarray(al1, f32)
    one_m_al1 = 1.0 - al1
    quad_only = al1_static is not None and float(al1_static) == 1.0

    # --- smoothness weights from mirror-shifted neighbours (ref :654-725) ---
    uW = mirror_shift(u, -1, -1, tw)
    uE = mirror_shift(u, 1, -1, tw)
    uN = mirror_shift(u, -1, -2, th)
    uS = mirror_shift(u, 1, -2, th)
    vW = mirror_shift(v, -1, -1, tw)
    vE = mirror_shift(v, 1, -1, tw)
    vN = mirror_shift(v, -1, -2, th)
    vS = mirror_shift(v, 1, -2, th)
    psisnmiuq = uW + uN + uE + uS
    psisnmivq = vW + vN + vE + vS

    if not quad_only:
        uNE = mirror_shift(uE, -1, -2, th)
        uSE = mirror_shift(uE, 1, -2, th)
        uNW = mirror_shift(uW, -1, -2, th)
        uSW = mirror_shift(uW, 1, -2, th)
        vNE = mirror_shift(vE, -1, -2, th)
        vSE = mirror_shift(vE, 1, -2, th)
        vNW = mirror_shift(vW, -1, -2, th)
        vSW = mirror_shift(vW, 1, -2, th)

        u_ip1 = _sq(uE - u) + _sq(0.25 * ((uSE - uNE) + (uS - uN))) \
            + _sq(vE - v) + _sq(0.25 * ((vSE - vNE) + (vS - vN)))
        u_im1 = _sq(u - uW) + _sq(0.25 * ((uSW - uNW) + (uS - uN))) \
            + _sq(v - vW) + _sq(0.25 * ((vSW - vNW) + (vS - vN)))
        u_jp1 = _sq(uS - u) + _sq(0.25 * ((uSE - uSW) + (uE - uW))) \
            + _sq(vS - v) + _sq(0.25 * ((vSE - vSW) + (vE - vW)))
        u_jm1 = _sq(u - uN) + _sq(0.25 * ((uNE - uNW) + (uE - uW))) \
            + _sq(v - vN) + _sq(0.25 * ((vNE - vNW) + (vE - vW)))

        psis1 = psi_deriv(u_im1)   # west
        psis2 = psi_deriv(u_jm1)   # north
        psis3 = psi_deriv(u_ip1)   # east
        psis4 = psi_deriv(u_jp1)   # south
        psistot = psis1 + psis2 + psis3 + psis4
        psisnmiu = psis1 * uW + psis2 * uN + psis3 * uE + psis4 * uS
        psisnmiv = psis1 * vW + psis2 * vN + psis3 * vE + psis4 * vS

    # --- warped data terms, accumulated over channels (ref :727-829) --------
    if warp_fn is None:
        def warp_fn(s, uu, vv):
            return warp_bilinear_dense(s, uu, vv, true_hw=(th, tw))
    if stack is None:
        stack = jnp.concatenate([geo2, gx2, gy2, gxx, gxy, gyy], axis=0)
    samples, bc_x, bc_y = warp_fn(stack, u, v)
    zero = jnp.zeros((h, w), f32)
    vr1 = vr2 = vr4 = vr5 = vr6 = intcomp = zero
    vr12 = vr22 = vr42 = vr52 = vr62 = intcomp2 = zero
    for c in range(c_):
        g2w = samples[c]
        ix = samples[c_ + c]
        iy = samples[2 * c_ + c]
        ixx = samples[3 * c_ + c]
        ixy = samples[4 * c_ + c]
        iyy = samples[5 * c_ + c]
        # zero warped gradients where the warp clamped (ref :767-779)
        ix = jnp.where(bc_x, 0.0, ix)
        ixx = jnp.where(bc_x, 0.0, ixx)
        iyy = jnp.where(bc_y, 0.0, iyy)
        ixy = jnp.where(bc_x | bc_y, 0.0, ixy)
        iy = jnp.where(bc_y, 0.0, iy)

        it = g2w - geo1[c]
        ixt = ix - gx1[c]
        iyt = iy - gy1[c]
        if dozim:
            na = 1.0 / (ix * ix + iy * iy + 1.0)
            nb = 1.0 / (ixx * ixx + ixy * ixy + 1.0)
            nc = 1.0 / (ixy * ixy + iyy * iyy + 1.0)
        else:
            na = nb = nc = jnp.ones((h, w), f32)
        intcomp = intcomp + na * it * it
        intcomp2 = intcomp2 + nb * ixt * ixt + nc * iyt * iyt
        vr1 = vr1 + na * ix * ix
        vr12 = vr12 + nb * ixx * ixx + nc * ixy * ixy
        vr2 = vr2 + na * ix * iy
        vr22 = vr22 + nb * ixx * ixy + nc * iyy * ixy
        vr4 = vr4 + na * iy * iy
        vr42 = vr42 + nb * ixy * ixy + nc * iyy * iyy
        vr5 = vr5 + (-na * it) * ix
        vr52 = vr52 - (nb * ixt * ixx + nc * iyt * ixy)
        vr6 = vr6 + (-na * it) * iy
        vr62 = vr62 - (nb * ixt * ixy + nc * iyt * iyy)

    hint_u = lambdac * (u - uhat)
    hint_v = lambdac * (v - vhat)

    if quad_only:
        # al1 == 1 at trace time: the pure-quadratic system of GNC step 0
        # (coefficients ref :837-865 with the robust half zeroed)
        a1 = vr1 / alpha + lam_over_alpha * vr12 + lambdac + 4.0
        a2 = vr2 / alpha + lam_over_alpha * vr22
        a4 = vr4 / alpha + lam_over_alpha * vr42 + lambdac + 4.0
        a5 = a6 = a7 = a8 = jnp.float32(-1.0)
        bu = vr5 / alpha + lam_over_alpha * vr52 - hint_u + psisnmiuq - 4.0 * u
        bv = vr6 / alpha + lam_over_alpha * vr62 - hint_v + psisnmivq - 4.0 * v
        return _mask_padded(
            StencilSystem(a1, a2, a4, a5, a6, a7, a8, bu, bv), th, tw, h, w)

    psid = psi_deriv(intcomp) / alpha
    psid2 = lam_over_alpha * psi_deriv(intcomp2)

    # --- stencil coefficients (ref :837-865) --------------------------------
    a1 = al1 * (vr1 / alpha + lam_over_alpha * vr12 + lambdac + 4.0) \
        + one_m_al1 * (psid * vr1 + psid2 * vr12 + lambdac + psistot)
    a2 = al1 * (vr2 / alpha + lam_over_alpha * vr22) \
        + one_m_al1 * (psid * vr2 + psid2 * vr22)
    a4 = al1 * (vr4 / alpha + lam_over_alpha * vr42 + lambdac + 4.0) \
        + one_m_al1 * (psid * vr4 + psid2 * vr42 + lambdac + psistot)
    a5 = -(al1 + one_m_al1 * psis1)
    a6 = -(al1 + one_m_al1 * psis2)
    a7 = -(al1 + one_m_al1 * psis3)
    a8 = -(al1 + one_m_al1 * psis4)

    # --- right-hand side (ref :1086-1093) -----------------------------------
    bu = al1 * (vr5 / alpha + lam_over_alpha * vr52 - hint_u + psisnmiuq - 4.0 * u) \
        + one_m_al1 * (psid * vr5 + psid2 * vr52 - hint_u + psisnmiu - psistot * u)
    bv = al1 * (vr6 / alpha + lam_over_alpha * vr62 - hint_v + psisnmivq - 4.0 * v) \
        + one_m_al1 * (psid * vr6 + psid2 * vr62 - hint_v + psisnmiv - psistot * v)

    return _mask_padded(
        StencilSystem(a1, a2, a4, a5, a6, a7, a8, bu, bv), th, tw, h, w)


def _mask_padded(sysm: StencilSystem, th, tw, h, w) -> StencilSystem:
    """Decouple mesh-divisibility padding rows: identity diagonal, zero
    off-diagonals and rhs.  Their CG residuals are then exactly zero, so
    padded pixels never influence dot products or true-pixel updates (the
    true edge pixels' out-of-range couplings are already folded back by the
    bounded mirror shifts in apply_stencil)."""
    if (th, tw) == (h, w):
        return sysm
    jj = jnp.arange(h, dtype=jnp.int32)[:, None]
    ii = jnp.arange(w, dtype=jnp.int32)[None, :]
    pad = (jj >= th) | (ii >= tw)

    def m(a, padval):
        return jnp.where(pad, jnp.float32(padval), a)

    return StencilSystem(
        m(sysm.a1, 1.0), m(sysm.a2, 0.0), m(sysm.a4, 1.0),
        m(sysm.a5, 0.0), m(sysm.a6, 0.0), m(sysm.a7, 0.0), m(sysm.a8, 0.0),
        m(sysm.bu, 0.0), m(sysm.bv, 0.0))
