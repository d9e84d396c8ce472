"""Bilinear and Catmull-Rom bicubic sampling.

Equivalents of oct_binterp.cc, oct_bicubic.cc and the device
copies in oct_variational_optical_flow.cu:56-71, 229-309.  Sample positions
may be traced arrays (warping) or trace-time constants (zooming); either way
the 4/16-tap gathers vectorize over the whole grid.

Index-casting semantics follow the reference exactly: C's ``(int)`` cast
truncates toward zero (NOT floor), and every tap index is clamped to
[0, n-1] independently (include/oct_bc.h).
"""

from __future__ import annotations

import jax.numpy as jnp


def _trunc_int(x: jnp.ndarray) -> jnp.ndarray:
    """C-style (int) cast: truncation toward zero."""
    return jnp.trunc(x).astype(jnp.int32)


def catmull_rom_cell(v0, v1, v2, v3, x):
    """1-D cubic convolution (oct_bicubic.cc:10-18)."""
    return v1 + 0.5 * x * (
        v2 - v0 + x * (2.0 * v0 - 5.0 * v1 + 4.0 * v2 - v3
                       + x * (3.0 * (v1 - v2) + v3 - v0))
    )


def _gather2d(img: jnp.ndarray, ix: jnp.ndarray, iy: jnp.ndarray) -> jnp.ndarray:
    """img[iy, ix] for integer index arrays (flat gather)."""
    w = img.shape[-1]
    flat = img.reshape(img.shape[:-2] + (-1,))
    return jnp.take(flat, iy * w + ix, axis=-1)


def bicubic_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Bicubic interpolation of ``img`` (..., H, W) at real positions (x, y).

    Matches oct_bicubic (oct_bicubic.cc:36-96): the 4 column / 4 row indices
    are (int)-truncated then clamped independently; the interpolation
    fraction is measured from the *clamped* integer base, so out-of-range
    positions extrapolate mildly rather than reflecting.
    """
    h, w = img.shape[-2], img.shape[-1]
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)

    def col_idx(off):
        return jnp.clip(_trunc_int(x + off), 0, w - 1)

    def row_idx(off):
        return jnp.clip(_trunc_int(y + off), 0, h - 1)

    xi = [col_idx(o) for o in (-1, 0, 1, 2)]
    yi = [row_idx(o) for o in (-1, 0, 1, 2)]
    fx = x - xi[1].astype(jnp.float32)
    fy = y - yi[1].astype(jnp.float32)

    cols = []
    for c in range(4):
        taps = [_gather2d(img, xi[c], yi[r]) for r in range(4)]
        cols.append(catmull_rom_cell(taps[0], taps[1], taps[2], taps[3], fy))
    return catmull_rom_cell(cols[0], cols[1], cols[2], cols[3], fx)


def bilinear_sample(img: jnp.ndarray, x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Plain bilinear interpolation with clamped cell origin.

    Matches the solver's warp lookup (oct_variational_optical_flow.cu:732-761):
    positions are clamped to [0, n-1], the cell origin additionally clamped to
    n-2 so all four corners are in range.
    """
    h, w = img.shape[-2], img.shape[-1]
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    # conditional clamp (oct_bc semantics): values in (n-1, n) pass through
    x = jnp.where(x < 0.0, 0.0, jnp.where(x >= w, float(w - 1), x))
    y = jnp.where(y < 0.0, 0.0, jnp.where(y >= h, float(h - 1), y))
    x0 = jnp.minimum(_trunc_int(x), w - 2)
    y0 = jnp.minimum(_trunc_int(y), h - 2)
    p1 = (x0 + 1).astype(jnp.float32) - x
    p2 = x - x0.astype(jnp.float32)
    p3 = (y0 + 1).astype(jnp.float32) - y
    p4 = y - y0.astype(jnp.float32)
    f11 = _gather2d(img, x0, y0)
    f21 = _gather2d(img, x0 + 1, y0)
    f12 = _gather2d(img, x0, y0 + 1)
    f22 = _gather2d(img, x0 + 1, y0 + 1)
    return p3 * (p1 * f11 + p2 * f21) + p4 * (p1 * f12 + p2 * f22)
