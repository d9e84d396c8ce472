"""Cross-bilateral flow smoothing ("SRSAL").

Equivalent of octsrsalcuda (oct_srsal_cuda.cu:34-71): a 37x37
(filtsigma=9, filtsize=18) spatial Gaussian times a cloud-top-height range
kernel exp(-dCTH^2 / (2*20^2)), applied to (u, v) with the reference's mixed
reflect boundary (left: reflect without edge repeat, right: symmetric with
edge repeat -- oct_bc_cuda, :15-28).

The filter is a `lax.fori_loop` over the 1369 taps of dynamic slices of
the padded fields (one pass over the planes per tap).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from octane_tpu.core.gaussian import gaussian_kernel_1d


def _reflect_pad(a: jnp.ndarray, p: int) -> jnp.ndarray:
    """Pad (H, W) with the reference's boundary map: index -k -> +k,
    index n-1+k -> n-k (oct_bc_cuda)."""
    top = jnp.flip(a[1:p + 1, :], axis=0)
    bot = jnp.flip(a[-p:, :], axis=0)
    a = jnp.concatenate([top, a, bot], axis=0)
    left = jnp.flip(a[:, 1:p + 1], axis=1)
    right = jnp.flip(a[:, -p:], axis=1)
    return jnp.concatenate([left, a, right], axis=1)


def _tap_loop(up, vp, cp, c0, gk, sigpix2, h, w):
    """The 1369-tap accumulation over pre-padded (+p each side) fields."""
    p = (up.shape[0] - h) // 2
    ntap = (2 * p + 1) ** 2

    def body(t, acc):
        au, av, a2 = acc
        kc = t // (2 * p + 1)
        lc = t % (2 * p + 1)
        # NOTE: reference indexes GK[kc] for the x-offset and GK[lc] for y.
        un = jax.lax.dynamic_slice(up, (lc, kc), (h, w))
        vn = jax.lax.dynamic_slice(vp, (lc, kc), (h, w))
        cn = jax.lax.dynamic_slice(cp, (lc, kc), (h, w))
        dmc = cn - c0
        a1 = gk[kc] * gk[lc] * jnp.exp(dmc * dmc * sigpix2)
        return au + un * a1, av + vn * a1, a2 + a1

    # zeros_like keeps the device-varying axes of c0 (shard_map vma)
    zero = jnp.zeros_like(c0)
    au, av, a2 = jax.lax.fori_loop(0, ntap, body, (zero, zero, zero))
    return au / a2, av / a2


def srsal_smooth(
    u: jnp.ndarray, v: jnp.ndarray, cth: jnp.ndarray,
    filtsigma: float = 9.0, sigpix: float = 20.0,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Bilateral smooth of (u, v) guided by ``cth``; returns (u_s, v_s).

    Defaults match oct_srsal_cu (oct_srsal_cuda.cu:73-82): filtsize =
    2*filtsigma = 18, range sigma 20 (CTH units).
    """
    p = int(2 * filtsigma)
    gk = jnp.asarray(gaussian_kernel_1d(filtsigma, p))            # 2p+1 taps
    sigpix2 = -1.0 / (2.0 * sigpix * sigpix)
    h, w = u.shape
    up = _reflect_pad(jnp.asarray(u, jnp.float32), p)
    vp = _reflect_pad(jnp.asarray(v, jnp.float32), p)
    cp = _reflect_pad(jnp.asarray(cth, jnp.float32), p)
    c0 = jnp.asarray(cth, jnp.float32)
    return _tap_loop(up, vp, cp, c0, gk, sigpix2, h, w)
