"""Image / flow resampling (pyramid construction and ingest regridding).

Two distinct code paths exist in the reference and both are replicated:

* the **solver pyramid** (device code, oct_variational_optical_flow.cu:352-466
  and 520-563): blur at full resolution then *integer* point-sampling --
  the bicubic call receives `int i2 = ii/factor`, so the fractional part is
  zero and the bicubic degenerates to a floor-subsample of the blurred image;
  flow upsampling is bicubic at half-pixel-offset positions divided by the
  pyramid scale factor;
* the **ingest zoom** (oct_zoom.cc): blur + bicubic at *real* positions
  (zoom_out), and bicubic/nearest at half-pixel-offset positions (zoom_in),
  used for multi-channel regridding and CTH remap.
"""

from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp
from jax import lax

from octane_tpu.core.gaussian import (
    gaussian_kernel_1d,
    blur_separable,
    solver_filtsize,
    ingest_filtsize,
)
from octane_tpu.core.interp import bicubic_sample

# The resampling matmuls must be float32-exact: at default precision a GPU
# may run them in TF32 (10-bit mantissa), which would move a one-hot
# "selection" of a 0-255 radiance by up to ~0.1.
_EXACT = lax.Precision.HIGHEST


def zoom_size(n: int, factor: float) -> int:
    """round-half-up size rule: int(n*factor + 0.5) (oct_zoom.cc:12-16)."""
    return int(float(n) * factor + 0.5)


def _weights_sigma(factor: float) -> float:
    """Gaussian weight sigma for downsampling: 0.6*sqrt(1/f^2 - 1)
    (fill_GK, oct_variational_optical_flow.cu:213; oct_zoom.cc:31)."""
    return 0.6 * math.sqrt(1.0 / (factor * factor) - 1.0)


def _catmull_matrix_1d(n_in: int, positions: np.ndarray,
                       clamp_n: int = None) -> jnp.ndarray:
    """(n_out, n_in) Catmull-Rom interpolation matrix for static positions.

    Weights follow oct_bicubic exactly: tap indices are (int)-truncated and
    clamped independently (clamped taps accumulate their weight onto the
    edge sample), the fraction is measured from the clamped base index.
    Expressing static-position resampling as a matrix turns it into a
    matmul, which XLA's SPMD partitioner shards natively.

    The tap indices/weights are computed host-side exactly as before (tiny
    (n_out, 4) constants) but the DENSE matrix is materialized on device
    from iota equality masks: baking the (n_out, n_in) literal into the
    program made full-disk modules gigabytes big (the 4-level 8192^2
    program exceeded the compile-service request limit).  Tap-collision
    accumulation order (clamped taps folding onto the edge sample) is
    preserved by summing the o = -1..2 masks in order.

    ``clamp_n`` clamps taps to a TRUE extent < n_in when the input carries
    trailing mesh-divisibility padding (padded columns are never read).
    """
    n_out = len(positions)
    cn = n_in if clamp_n is None else clamp_n
    taps = np.zeros((n_out, 4), np.int32)
    wgts = np.zeros((n_out, 4), np.float32)
    for r, p in enumerate(positions):
        t = [min(max(int(np.trunc(p + o)), 0), cn - 1) for o in (-1, 0, 1, 2)]
        x = np.float32(p) - np.float32(t[1])
        taps[r] = t
        wgts[r] = (0.5 * (-x + 2 * x * x - x ** 3),
                   1.0 - 2.5 * x * x + 1.5 * x ** 3,
                   0.5 * (x + 4 * x * x - 3 * x ** 3),
                   0.5 * (-x * x + x ** 3))
    cols = jnp.arange(n_in, dtype=jnp.int32)[None, :]
    tj = jnp.asarray(taps)
    wj = jnp.asarray(wgts)
    m = jnp.zeros((n_out, n_in), jnp.float32)
    for o in range(4):
        m = m + jnp.where(cols == tj[:, o:o + 1], wj[:, o:o + 1], 0.0)
    return m


def _onehot_rows(idx: np.ndarray, n_in: int) -> jnp.ndarray:
    """(n_out, n_in) one-hot selection matrix from static row indices,
    materialized on device (see _catmull_matrix_1d on why not a literal)."""
    cols = jnp.arange(n_in, dtype=jnp.int32)[None, :]
    return (cols == jnp.asarray(idx, jnp.int32)[:, None]).astype(jnp.float32)


def pyramid_downsample(img: jnp.ndarray, factor: float,
                       true_in=None) -> jnp.ndarray:
    """Solver-path downsample of a full-resolution (..., H, W) image.

    Blur with the per-level solver kernel, then point-sample at
    (trunc(jj/factor), trunc(ii/factor)) -- replicating the degenerate
    integer-position bicubic of zoom_out (oct_variational_optical_flow.cu:
    352-408, note `int i2 = ii/factor` at :369).  The subsample is a pair of
    one-hot selection matmuls so it shards under GSPMD.

    ``true_in`` gives the true (H, W) when ``img`` carries trailing
    mesh-divisibility padding.  The padded region of the input must be
    edge-replicated (then the clamp-BC blur is exact at true pixels); the
    subsample reads only true columns, and padded OUTPUT positions replicate
    the last true level pixel.
    """
    h, w = img.shape[-2], img.shape[-1]
    nxx, nyy = zoom_size(w, factor), zoom_size(h, factor)
    th, tw = (h, w) if true_in is None else true_in
    tny, tnx = zoom_size(th, factor), zoom_size(tw, factor)
    fs = solver_filtsize(factor)
    kern = gaussian_kernel_1d(_weights_sigma(factor), fs)
    blurred = blur_separable(img, kern, fs)
    # static integer subsample indices (float32 division + trunc, like CUDA);
    # padded output rows/cols re-sample the last true index
    ii = np.clip(np.trunc(np.minimum(np.arange(nxx), tnx - 1).astype(np.float32)
                          / np.float32(factor)).astype(np.int64), 0, tw - 1)
    jj = np.clip(np.trunc(np.minimum(np.arange(nyy), tny - 1).astype(np.float32)
                          / np.float32(factor)).astype(np.int64), 0, th - 1)
    out = jnp.einsum("yh,...hw->...yw", _onehot_rows(jj, h), blurred,
                     precision=_EXACT, preferred_element_type=jnp.float32)
    return jnp.einsum("xw,...yw->...yx", _onehot_rows(ii, w), out,
                      precision=_EXACT, preferred_element_type=jnp.float32)


def zoom_in_flow(flow: jnp.ndarray, new_hw, scale_factor: float,
                 true_in=None, true_out=None) -> jnp.ndarray:
    """Upsample a flow field to the next pyramid level and rescale it.

    Bicubic at i2 = ii/fx - (0.5 - 0.5/fx) (half-pixel centre offset), then
    divided by ``scale_factor`` to convert displacements to the finer grid
    (zoom_in, oct_variational_optical_flow.cu:450-466).  Separable
    interpolation matrices -> two matmuls (GSPMD-shardable).

    With ``true_in``/``true_out`` set (mesh-divisibility padding), the
    positions and the fx/fy ratios come from the TRUE level sizes -- so true
    pixels match the unpadded solve bit-for-bit -- taps never read padded
    input, and padded output rows replicate the last true row.
    """
    nyy, nxx = new_hw
    h, w = flow.shape[-2], flow.shape[-1]
    tih, tiw = (h, w) if true_in is None else true_in
    toh, tow = (nyy, nxx) if true_out is None else true_out
    fx = np.float32(tow) / np.float32(tiw)
    fy = np.float32(toh) / np.float32(tih)
    iis = np.minimum(np.arange(nxx), tow - 1).astype(np.float32)
    jjs = np.minimum(np.arange(nyy), toh - 1).astype(np.float32)
    i2 = (iis / fx) - (np.float32(0.5) - np.float32(0.5) / fx)
    j2 = (jjs / fy) - (np.float32(0.5) - np.float32(0.5) / fy)
    ry = _catmull_matrix_1d(h, j2, clamp_n=tih)
    rx = _catmull_matrix_1d(w, i2, clamp_n=tiw)
    out = jnp.einsum("yh,...hw->...yw", ry, flow,
                     precision=_EXACT, preferred_element_type=jnp.float32)
    out = jnp.einsum("xw,...yw->...yx", rx, out,
                     precision=_EXACT, preferred_element_type=jnp.float32)
    return out / jnp.float32(scale_factor)


def zoom_out_image(img: jnp.ndarray, factor: float) -> jnp.ndarray:
    """Ingest-path zoom out: blur + bicubic at real positions ii/factor
    (oct_zoom_out_float, oct_zoom.cc:51-88)."""
    h, w = img.shape[-2], img.shape[-1]
    if factor >= 0.999999:
        return img
    nxx, nyy = zoom_size(w, factor), zoom_size(h, factor)
    sigma = _weights_sigma(factor)
    fs = ingest_filtsize(sigma)
    kern = gaussian_kernel_1d(sigma, fs)
    blurred = blur_separable(img, kern, fs)
    i2 = (np.arange(nxx, dtype=np.float64) / factor).astype(np.float32)
    j2 = (np.arange(nyy, dtype=np.float64) / factor).astype(np.float32)
    xg = np.broadcast_to(i2[None, :], (nyy, nxx))
    yg = np.broadcast_to(j2[:, None], (nyy, nxx))
    return bicubic_sample(blurred, jnp.asarray(xg), jnp.asarray(yg))


def zoom_out_image_rows(read_rows, h_in: int, w_in: int, factor: float,
                        row_range) -> jnp.ndarray:
    """Exact OUTPUT row block [r0, r1) of ``zoom_out_image`` on a source
    known only through ``read_rows(s0, s1) -> (s1-s0, w_in) array``.

    Reads a margin-extended source hyperslab (bicubic taps +-2, blur
    +-filtsize) so clamp boundary conditions at the block edges are never
    exercised except where the block edge IS the global edge -- the output
    equals zoom_out_image(full)[r0:r1] exactly (positions are sliced from
    the full-grid arrays, so float rounding is identical).  This is what
    makes host-sharded multi-channel/CTH ingest possible without any host
    ever reading the full source grid.
    """
    r0, r1 = row_range
    if factor >= 0.999999:
        return jnp.asarray(read_rows(r0, r1))
    nyy = zoom_size(h_in, factor)
    nxx = zoom_size(w_in, factor)
    sigma = _weights_sigma(factor)
    fs = ingest_filtsize(sigma)
    kern = gaussian_kernel_1d(sigma, fs)
    j2 = (np.arange(nyy, dtype=np.float64) / factor).astype(np.float32)[r0:r1]
    s0 = max(0, int(np.floor(float(j2.min()))) - 2 - fs)
    s1 = min(h_in, int(np.ceil(float(j2.max()))) + 3 + fs)
    blk = jnp.asarray(read_rows(s0, s1))
    blurred = blur_separable(blk, kern, fs)
    i2 = (np.arange(nxx, dtype=np.float64) / factor).astype(np.float32)
    xg = np.broadcast_to(i2[None, :], (r1 - r0, nxx))
    yg = np.broadcast_to((j2 - np.float32(s0))[:, None], (r1 - r0, nxx))
    return bicubic_sample(blurred, jnp.asarray(xg), jnp.asarray(yg))


def zoom_in_image_rows(read_rows, h_in: int, w_in: int, new_hw, row_range,
                       bicubic: bool = True) -> jnp.ndarray:
    """Exact OUTPUT row block [r0, r1) of ``zoom_in_image`` (see
    zoom_out_image_rows; margin is the bicubic +-2 tap support)."""
    nyy, nxx = new_hw
    r0, r1 = row_range
    fx = np.float32(nxx) / np.float32(w_in)
    fy = np.float32(nyy) / np.float32(h_in)
    i2 = (np.arange(nxx, dtype=np.float32) / fx) - (
        np.float32(0.5) - np.float32(0.5) / fx)
    j2 = ((np.arange(nyy, dtype=np.float32) / fy) - (
        np.float32(0.5) - np.float32(0.5) / fy))[r0:r1]
    s0 = max(0, int(np.floor(float(j2.min()))) - 2)
    s1 = min(h_in, int(np.floor(float(j2.max()))) + 4)
    blk = jnp.asarray(read_rows(s0, s1))
    j2l = j2 - np.float32(s0)
    if bicubic:
        xg = np.broadcast_to(i2[None, :], (r1 - r0, nxx))
        yg = np.broadcast_to(j2l[:, None], (r1 - r0, nxx))
        return bicubic_sample(blk, jnp.asarray(xg), jnp.asarray(yg))
    i3 = np.clip((i2 + 0.5).astype(np.int32), 0, w_in - 1)
    j3 = np.clip((j2 + 0.5).astype(np.int32), 0, h_in - 1) - s0
    return blk[..., j3[:, None], i3[None, :]]


def zoom_in_image(img: jnp.ndarray, new_hw, bicubic: bool = True) -> jnp.ndarray:
    """Ingest-path zoom in with half-pixel offset; bicubic or nearest
    (oct_zoom_in_float, oct_zoom.cc:180-222; nearest used for CTH when
    -nncth is set)."""
    nyy, nxx = new_hw
    h, w = img.shape[-2], img.shape[-1]
    fx = np.float32(nxx) / np.float32(w)
    fy = np.float32(nyy) / np.float32(h)
    i2 = (np.arange(nxx, dtype=np.float32) / fx) - (np.float32(0.5) - np.float32(0.5) / fx)
    j2 = (np.arange(nyy, dtype=np.float32) / fy) - (np.float32(0.5) - np.float32(0.5) / fy)
    if bicubic:
        xg = np.broadcast_to(i2[None, :], (nyy, nxx))
        yg = np.broadcast_to(j2[:, None], (nyy, nxx))
        return bicubic_sample(img, jnp.asarray(xg), jnp.asarray(yg))
    i3 = np.clip((i2 + 0.5).astype(np.int32), 0, w - 1)
    j3 = np.clip((j2 + 0.5).astype(np.int32), 0, h - 1)
    return img[..., j3[:, None], i3[None, :]]
