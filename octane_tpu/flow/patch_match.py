"""Patch-match (sum-of-squared-error minimization) optical flow.

A redesign of oct_patch_match_optical_flow.cc:56-156.  The serial
spiral search becomes a `lax.fori_loop` over the spiral offset table carrying
the running (best cost, offset) per pixel -- O(patch) live memory instead of
materializing a cost volume, so full-disk grids fit in HBM.  Ties resolve to
the first offset in the reference's spiral visit order (the strict `<` update
keeps the earliest minimum, same as the reference's serial scan).  The
quadratic sub-pixel refinement (jquad_interp, :35-55) probes the four offset
neighbours of the argmin, evaluated fresh (they may fall outside the search
square, ref :133-134), and is applied in offset coordinates -- the same
parabola-vertex formula without the large-coordinate cancellation.

Two cost paths:

* **zero first guess** (``u0 is None`` -- the hybrid/init configuration):
  patch centres are the pixels themselves, so each offset's cost is a sum of
  *contiguous shifted windows* (dynamic slices of edge-padded images, pure
  VPU traffic, no gathers).  This is the path that scales to full-disk and
  the one ``patch_match_flow_sharded`` runs per shard with a halo exchange.
* **navigated first guess**: patch centres are truncated per-pixel positions
  `ibc = clamp(trunc(i + u_fg))` (ref :98-99) and every tap is a clamped
  gather; the returned displacement is measured relative to that centre, NOT
  added to the first guess (ref :138).  This path is (2*rad+1)^2 x
  (2*srad+1)^2 full-field gathers and is intended for SECTOR-SCALE grids
  (mesoscale sequences with -sosm warm starts); full-disk hybrid runs are
  zero-guess and take the slice path above.  At full disk with a first
  guess, prefer `-hybrid` (the variational refiner absorbs the guess via
  uv2pix) or quantize the guess into the search window.

Reference quirks replicated: the spiral bounds check `(-SXD2 < n <= SXD2)` is
a C parsing bug that is always true, so every visited offset participates
(ref :102-104) -- the effective search set is the full (2*srad+1)^2 square in
spiral visit order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P


def spiral_offsets(srad: int) -> np.ndarray:
    """Offsets (n, m) in the reference's spiral visit order (ref :93-131)."""
    n = m = 0
    dn, dm = 0, -1
    out = []
    for _ in range((2 * srad + 1) ** 2):
        out.append((n, m))
        if (n == m) or (n < 0 and n == -m) or (n > 0 and n == 1 - m):
            dn, dm = -dm, dn
        n += dn
        m += dm
    return np.asarray(out, np.int32)


def _cost_gather(geo1, geo2, ibc, jbc, n, m, rad, h, w):
    """SSD over the (2*rad+1)^2 patch with per-tap clamped indices
    (jsose, ref :12-33).  ``n``/``m`` may be scalars or (H, W) arrays."""
    acc = None
    for k in range(-rad, rad + 1):
        for l in range(-rad, rad + 1):
            x1 = jnp.clip(ibc + k, 0, w - 1)
            y1 = jnp.clip(jbc + l, 0, h - 1)
            x2 = jnp.clip(ibc + (k + n), 0, w - 1)
            y2 = jnp.clip(jbc + (l + m), 0, h - 1)
            d = geo2[y2, x2] - geo1[y1, x1]
            acc = d * d if acc is None else acc + d * d
    return acc


def _refine(center, c0, c_plus, c_minus):
    """Parabola-vertex sub-pixel refinement (jquad_interp, ref :35-55)."""
    denom = 2.0 * (c_plus + c_minus - 2.0 * c0)
    vertex = center.astype(jnp.float32) + jnp.where(
        denom == 0.0, 0.0, (c_minus - c_plus) / jnp.where(denom == 0.0, 1.0, denom)
    )
    ok = (c0 < c_plus) & (c0 < c_minus)
    return jnp.where(ok, vertex, center.astype(jnp.float32))


def _spiral_argmin(cost_fn, srad: int):
    """fori_loop over the spiral offset table; first strict minimum wins."""
    order = spiral_offsets(srad)
    n_of = jnp.asarray(order[:, 0])
    m_of = jnp.asarray(order[:, 1])

    def body(i, st):
        best, nmin, mmin = st
        n, m = n_of[i], m_of[i]
        c = cost_fn(n, m)
        upd = c < best
        return (jnp.where(upd, c, best),
                jnp.where(upd, n, nmin).astype(jnp.int32),
                jnp.where(upd, m, mmin).astype(jnp.int32))

    c00 = cost_fn(n_of[0], m_of[0])                      # spiral starts (0,0)
    # zeros_like keeps the device-varying axes of the cost (shard_map vma)
    zero_i = jnp.zeros_like(c00, dtype=jnp.int32)
    return lax.fori_loop(1, len(order), body, (c00, zero_i, zero_i))


def _finish(nmin, mmin, probe_cost):
    # Re-evaluate the winning cost through the same code path as the probes:
    # the fori_loop's accumulation may be contracted (FMA) differently by
    # XLA, and a 1-ulp drift would flip the strict-inequality gate exactly
    # at the clamped-edge ties where c0 == c_minus in the reference.
    c0 = probe_cost(nmin, mmin)
    su1 = probe_cost(nmin + 1, mmin)
    su2 = probe_cost(nmin - 1, mmin)
    sv1 = probe_cost(nmin, mmin + 1)
    sv2 = probe_cost(nmin, mmin - 1)
    u = _refine(nmin, c0, su1, su2)
    v = _refine(mmin, c0, sv1, sv2)
    return u, v


def _patch_match_local(g1, g2, rad, srad, h, w, gy0=0, gx0=0, halo=0):
    """Zero-guess patch match on one (local) block.

    ``g1``/``g2`` are the local blocks; with ``halo`` > 0 they must already
    be halo-padded by ``rad`` and ``rad + srad + 1`` respectively (global
    edge replication reproduces the reference's clamped reads exactly).
    ``(gy0, gx0)``/(h, w) are the block's global origin / the global dims
    (used by the sector-scale gather probes' clamping; the full-disk
    slice/select refine needs only the halo-padded blocks).
    """
    smax = rad + srad + 1
    if halo == 0:
        g1p = jnp.pad(g1, rad, mode="edge")
        g2p = jnp.pad(g2, smax, mode="edge")
    else:
        g1p, g2p = g1, g2
    hl = g1p.shape[0] - 2 * rad
    wl = g1p.shape[1] - 2 * rad

    if hl * wl <= FIRST_GUESS_MAX_PIXELS:
        def cost_slices(n, m):
            acc = None
            for k in range(-rad, rad + 1):
                for l in range(-rad, rad + 1):
                    t1 = g1p[rad + l:rad + l + hl, rad + k:rad + k + wl]
                    t2 = lax.dynamic_slice(
                        g2p, (smax + l + m, smax + k + n), (hl, wl))
                    d = t2 - t1
                    acc = d * d if acc is None else acc + d * d
            return acc
    else:
        # Full-disk scale: every tap of the (n, m) cost plane is a shifted
        # window of ONE squared-diff plane e^2 where
        # e(y, x) = g2p[y + m + (smax-rad), x + n + (smax-rad)] - g1p[y, x]
        # (each term equals the per-tap t2 - t1 elementwise, summed in the
        # same k-major order) -- ~2.7x fewer plane ops per cost
        # evaluation.  Used only above the sector-scale guard: the
        # unfactored form's mul-add chain may FMA-contract, and the
        # sector-scale path's bit-equality contract with the gather
        # first-guess path depends on matching it exactly.
        def cost_slices(n, m):
            e = lax.dynamic_slice(
                g2p, (smax - rad + m, smax - rad + n),
                (hl + 2 * rad, wl + 2 * rad)) - g1p
            e2 = e * e
            acc = None
            for k in range(-rad, rad + 1):
                for l in range(-rad, rad + 1):
                    t = e2[rad + l:rad + l + hl, rad + k:rad + k + wl]
                    acc = t if acc is None else acc + t
            return acc

    _, nmin, mmin = _spiral_argmin(cost_slices, srad)

    if hl * wl <= FIRST_GUESS_MAX_PIXELS:
        # Sector scale: per-pixel clamped GATHER probes, structurally
        # identical to the first-guess path's cost fn, which is what makes
        # the u0=None fast path bit-equal to the u0=zeros gather path
        # (tests/test_patch_match.py::test_fast_path_matches_gather_path).
        ii = gx0 + jnp.arange(wl, dtype=jnp.int32)[None, :]
        jj = gy0 + jnp.arange(hl, dtype=jnp.int32)[:, None]

        def probe_cost(n, m):
            acc = None
            for k in range(-rad, rad + 1):
                for l in range(-rad, rad + 1):
                    x1 = jnp.clip(ii + k, 0, w - 1) - gx0 + rad
                    y1 = jnp.clip(jj + l, 0, h - 1) - gy0 + rad
                    x2 = jnp.clip(ii + (k + n), 0, w - 1) - gx0 + smax
                    y2 = jnp.clip(jj + (l + m), 0, h - 1) - gy0 + smax
                    d = g2p[y2, x2] - g1p[y1, x1]
                    acc = d * d if acc is None else acc + d * d
            return acc

        return _finish(nmin, mmin, probe_cost)

    # Full-disk scale (no gather twin exists here -- the first-guess path
    # refuses above the guard): the refine probes only ever need the cost
    # at 2*(srad+1)+1 squared static offsets, so evaluate each ONCE
    # through the same slice path as the spiral and per-pixel SELECT.  A
    # fori_loop (like the spiral) rather than a Python unroll: the
    # unrolled gather probes kept 25 full-field gather temps live per
    # probe (the select unroll additionally let XLA remat-clone the pad
    # concats into every consumer fusion, 23.8 GB requested at 8192^2);
    # the loop carry bounds liveness at the 5 accumulators + one plane.
    probes = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1))   # c0, su1, su2,
    s1 = srad + 1                                         # sv1, sv2
    # the probe pattern is cross-shaped, so the 4 corner offsets
    # (|n| = |m| = srad+1) can never be selected -- skip them
    offs = jnp.asarray([(n, m)
                        for n in range(-s1, s1 + 1)
                        for m in range(-s1, s1 + 1)
                        if not (abs(n) == s1 and abs(m) == s1)], jnp.int32)

    def refine_body(t, accs):
        n = offs[t, 0]
        m = offs[t, 1]
        c = cost_slices(n, m)
        out = []
        for a, (dn, dm) in zip(accs, probes):
            sel = (nmin + dn == n) & (mmin + dm == m)
            out.append(jnp.where(sel, c, a))
        return tuple(out)

    zero = jnp.zeros((hl, wl), jnp.float32)
    c0, su1, su2, sv1, sv2 = lax.fori_loop(
        0, len(offs), refine_body, (zero,) * 5)
    u = _refine(nmin, c0, su1, su2)
    v = _refine(mmin, c0, sv1, sv2)
    return u, v


# The first-guess path materializes (2*rad+1)^2 * (2*srad+1)^2 full-field
# arbitrary gathers per spiral probe (the guess bends the per-pixel patch
# origins, so the slice fast path does not apply) -- fine at sector scale,
# but at full-disk dims it compiles to hundreds of GB of gather traffic.
# Guarded: callers above this size get a clear refusal instead of an
# OOM/hour-long compile.  The zero-guess path (slices) is unaffected.
FIRST_GUESS_MAX_PIXELS = 8_000_000    # > CONUS band-2 1 km (~3.8 Mpix)


def patch_match_flow(
    geo1: jnp.ndarray,
    geo2: jnp.ndarray,
    u0: Optional[jnp.ndarray] = None,
    v0: Optional[jnp.ndarray] = None,
    rad: int = 2,
    srad: int = 2,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Dense SSD minimization; returns (u, v) pixel displacements.

    geo1/geo2: (H, W) float32.  ``u0``/``v0`` optionally give first-guess
    displacements; pass None (not zeros) to take the slice-based fast path.
    The first-guess path is sector-scale only (see FIRST_GUESS_MAX_PIXELS);
    for larger grids use algorithm='hybrid' (zero-guess patch-match init +
    variational refinement, which consumes the first guess) or drop the
    first guess.  Reference anchor: oct_patch_match_optical_flow.cc:56-156
    is single-scale CPU code that was never run at full-disk size.
    """
    geo1 = jnp.asarray(geo1, jnp.float32)
    geo2 = jnp.asarray(geo2, jnp.float32)
    h, w = geo1.shape

    if u0 is None:
        return _patch_match_local(geo1, geo2, rad, srad, h, w)

    if h * w > FIRST_GUESS_MAX_PIXELS:
        raise ValueError(
            f"patch-match with a first guess is sector-scale only: "
            f"{h}x{w} = {h * w / 1e6:.1f} Mpix exceeds the "
            f"{FIRST_GUESS_MAX_PIXELS / 1e6:.0f} Mpix guard (the guessed "
            f"patch origins force {(2 * rad + 1) ** 2} full-field gathers "
            f"per spiral probe).  Use -hybrid (patch-match init + "
            f"variational refinement, which consumes the first guess) or "
            f"drop -firstguess for -sosm.")

    ii = jnp.arange(w, dtype=jnp.float32)[None, :]
    jj = jnp.arange(h, dtype=jnp.float32)[:, None]
    ibc = jnp.clip(jnp.trunc(ii + u0).astype(jnp.int32), 0, w - 1)
    jbc = jnp.clip(jnp.trunc(jj + v0).astype(jnp.int32), 0, h - 1)
    ibc = jnp.broadcast_to(ibc, (h, w))
    jbc = jnp.broadcast_to(jbc, (h, w))

    def cost(n, m):
        return _cost_gather(geo1, geo2, ibc, jbc, n, m, rad, h, w)

    _, nmin, mmin = _spiral_argmin(cost, srad)
    return _finish(nmin, mmin, cost)


def patch_match_flow_sharded(geo1, geo2, mesh, rad: int = 2, srad: int = 2):
    """Zero-first-guess patch match over a ("dy", "dx") device mesh.

    Each shard exchanges a (rad)/(rad+srad+1) halo via ppermute (edge
    replication at the global boundary == the reference's clamped reads)
    and runs the same spiral loop locally; results are bit-identical to the
    single-device fast path.
    """
    from octane_tpu.parallel.halo import halo_pad2d

    geo1 = jnp.asarray(geo1, jnp.float32)
    geo2 = jnp.asarray(geo2, jnp.float32)
    h, w = geo1.shape
    smax = rad + srad + 1
    ry, rx = mesh.shape["dy"], mesh.shape["dx"]
    # real sector dims rarely divide the mesh: edge-replication pad to the
    # next divisible shape and crop.  Exact for every true pixel -- the
    # reference's clamped reads beyond the true edge return the edge value,
    # which is precisely what the replicated pad columns/rows hold.
    hp = -(-h // ry) * ry
    wp = -(-w // rx) * rx
    if (hp, wp) != (h, w):
        geo1 = jnp.pad(geo1, ((0, hp - h), (0, wp - w)), mode="edge")
        geo2 = jnp.pad(geo2, ((0, hp - h), (0, wp - w)), mode="edge")
    hl, wl = hp // ry, wp // rx

    import functools

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("dy", "dx"), P("dy", "dx")),
        out_specs=(P("dy", "dx"), P("dy", "dx")))
    def run(g1, g2):
        gy0 = lax.axis_index("dy") * hl
        gx0 = lax.axis_index("dx") * wl
        g1p = halo_pad2d(g1, rad)
        g2p = halo_pad2d(g2, smax)
        # padded dims as the clamp bounds: replication makes reads beyond
        # the true edge equal to the reference's clamped reads
        return _patch_match_local(g1p, g2p, rad, srad, hp, wp,
                                  gy0=gy0, gx0=gx0, halo=1)

    u, v = run(geo1, geo2)
    if (hp, wp) != (h, w):
        u = u[:h, :w]
        v = v[:h, :w]
    return u, v
