"""Temporal frame interpolation (Baker et al. 2011 style).

A redesign of oct_interp.cc.  The serial forward-splat with
color-constancy conflict resolution (oct_warpflow, :17-63) becomes three
scatter-min passes (min cost, then min scan-order among cost ties, then the
winner writes its flow), which reproduces the reference's "first writer in
scan order wins ties" exactly but in parallel.  The serial outside-in hole
fill (:182-250) becomes a Jacobi fixed-point iteration of the masked 3x3
neighbour mean -- behaviourally equivalent (all holes filled from the same
neighbourhoods) though not bitwise identical to the sweep order.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

_HOLE = -999.0
_BIGCOST = 999999.0


def _round_half_up(x):
    return jnp.floor(x + 0.5)


def forward_splat(u, v, im1, im2, time):
    """Splat flow to time ``time``; returns (ut, vt) with -999 holes.

    Each source pixel writes its flow to the 2x2 footprint at
    round(i + time*u) (clamped to [0, n-2]); conflicts resolve to the source
    with the smallest color-constancy cost (im1[src] - im2[src + round(flow)])^2,
    ties to the first writer in scan order (oct_warpflow).
    """
    h, w = u.shape
    ii = jnp.arange(w, dtype=jnp.float32)[None, :]
    jj = jnp.arange(h, dtype=jnp.float32)[:, None]
    iv = jnp.clip(_round_half_up(ii + time * u), 0, w - 2).astype(jnp.int32)
    jv = jnp.clip(_round_half_up(jj + time * v), 0, h - 2).astype(jnp.int32)
    iv2 = jnp.clip(_round_half_up(ii + u), 0, w - 2).astype(jnp.int32)
    jv2 = jnp.clip(_round_half_up(jj + v), 0, h - 2).astype(jnp.int32)

    src = (jj.astype(jnp.int32) * w + ii.astype(jnp.int32)).reshape(-1)
    n = h * w
    best_cost = jnp.full((n,), _BIGCOST + 1.0, jnp.float32)
    tgts, costs, orders = [], [], []
    for l in range(2):
        for k in range(2):
            tgt = ((jv + l) * w + (iv + k)).reshape(-1)
            diff = im1 - im2[jv2 + l, iv2 + k]
            cost = (diff * diff).reshape(-1)
            order = src * 4 + l * 2 + k
            tgts.append(tgt)
            costs.append(cost)
            orders.append(order)
    tgt = jnp.concatenate(tgts)
    cost = jnp.concatenate(costs)
    order = jnp.concatenate(orders)

    best_cost = best_cost.at[tgt].min(cost)
    tie = cost == best_cost[tgt]
    big_order = jnp.iinfo(jnp.int32).max
    best_order = jnp.full((n,), big_order, jnp.int32)
    best_order = best_order.at[tgt].min(jnp.where(tie, order, big_order))
    win = tie & (order == best_order[tgt])

    uflat = jnp.tile(u.reshape(-1), 4)
    vflat = jnp.tile(v.reshape(-1), 4)
    ut = jnp.full((n,), _HOLE, jnp.float32)
    vt = jnp.full((n,), _HOLE, jnp.float32)
    ut = ut.at[jnp.where(win, tgt, n)].set(uflat, mode="drop")
    vt = vt.at[jnp.where(win, tgt, n)].set(vflat, mode="drop")
    return ut.reshape(h, w), vt.reshape(h, w)


def fill_holes(ut, vt, max_iters: int = 10000):
    """Fill -999 holes by iterated masked 3x3 neighbour means.

    ``max_iters`` bounds the fixed-point iteration so an all-hole field
    (e.g. flow products that are entirely fill values) terminates instead of
    spinning on device; any holes still left keep the -999 sentinel.
    """
    h, w = ut.shape

    def neighbours(a):
        ap = jnp.pad(a, 1, constant_values=_HOLE)
        out = []
        for dj in (-1, 0, 1):
            for di in (-1, 0, 1):
                if dj == 0 and di == 0:
                    continue
                out.append(ap[1 + dj:1 + dj + h, 1 + di:1 + di + w])
        return out

    def step(state):
        ut, vt, _, it = state
        hole = ut < -998.0
        nsu = neighbours(ut)
        nsv = neighbours(vt)
        cnt = sum(jnp.where(x > -998.0, 1.0, 0.0) for x in nsu)
        su = sum(jnp.where(x > -998.0, x, 0.0) for x in nsu)
        sv = sum(jnp.where(x > -998.0, x, 0.0) for x in nsv)
        can = hole & (cnt > 0)
        ut = jnp.where(can, su / jnp.maximum(cnt, 1.0), ut)
        vt = jnp.where(can, sv / jnp.maximum(cnt, 1.0), vt)
        return ut, vt, jnp.sum(ut < -998.0), it + 1

    def cond(state):
        return (state[2] > 0) & (state[3] < max_iters)

    ut, vt, _, _ = jax.lax.while_loop(
        cond, step, (ut, vt, jnp.sum(ut < -998.0), jnp.int32(0)))
    return ut, vt


def interpolate_frame(
    u, v, im1, im2, frac: float,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Synthesize the frame at t1 + frac*(t2-t1).

    u/v: (H, W) flow in pixels; im1/im2: (C, H, W) normalized images.
    Returns (img, occ): the interpolated (C, H, W) image in normalized units
    and the (H, W) int16 occlusion mask (0 both, 1 only-in-image-1,
    2 only-in-image-2) -- keys per oct_filewrite.cc:185.
    """
    c_, h, w = im1.shape
    time = jnp.float32(frac)
    ut, vt = forward_splat(u, v, im1[0], im2[0], time)
    ut, vt = fill_holes(ut, vt)
    ut2, _vt2 = forward_splat(u, v, im1[0], im2[0], jnp.float32(1.0))

    ii = jnp.arange(w, dtype=jnp.float32)[None, :]
    jj = jnp.arange(h, dtype=jnp.float32)[:, None]
    o1a = (ut2 < -998.0)
    iv = jnp.clip(_round_half_up(ii + u), 0, w - 2).astype(jnp.int32)
    jv = jnp.clip(_round_half_up(jj + v), 0, h - 2).astype(jnp.int32)
    du = u - ut2[jv, iv]
    dv = v - _vt2[jv, iv]
    o0a = (~o1a) & (du * du + dv * dv > 0.25)

    def clamp_pos(x, n):
        return jnp.clip(x, 0.0, n - 2)

    x00 = clamp_pos(ii - time * ut, w)
    y00 = clamp_pos(jj - time * vt, h)
    x10 = clamp_pos(ii + (1.0 - time) * ut, w)
    y10 = clamp_pos(jj + (1.0 - time) * vt, h)

    def bilinear(img, x, y):
        x1 = jnp.trunc(x).astype(jnp.int32)
        y1 = jnp.trunc(y).astype(jnp.int32)
        fx = x - x1
        fy = y - y1
        f11 = img[..., y1, x1]
        f21 = img[..., y1, x1 + 1]
        f12 = img[..., y1 + 1, x1]
        f22 = img[..., y1 + 1, x1 + 1]
        return (1 - fy) * ((1 - fx) * f11 + fx * f21) + fy * ((1 - fx) * f12 + fx * f22)

    i0 = bilinear(im1, x00, y00)       # (C, H, W)
    i1 = bilinear(im2, x10, y10)

    x0i = jnp.trunc(x00 + 0.5).astype(jnp.int32)
    y0i = jnp.trunc(y00 + 0.5).astype(jnp.int32)
    x1i = jnp.trunc(x10 + 0.5).astype(jnp.int32)
    y1i = jnp.trunc(y10 + 0.5).astype(jnp.int32)
    o0 = o0a[y0i, x0i]
    o1 = o1a[y1i, x1i]

    both = (~o0) & (~o1)
    img = jnp.where(both[None], (1.0 - time) * i0 + time * i1,
                    jnp.where(o1[None], i0, i1))
    occ = jnp.where(both, 0, jnp.where(o1, 2, 1)).astype(jnp.int16)
    return img, occ
