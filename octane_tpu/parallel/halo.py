"""Halo exchange primitives (used inside shard_map).

Each shard pads its local block with ``halo`` rows/columns from its mesh
neighbours via `lax.ppermute`; shards on the global
boundary fill the missing halo by edge replication, which is safe because
globally-clamped positions never index past the true image edge.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _edge(x, axis, front: bool, halo: int):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(0, 1) if front else slice(x.shape[axis] - 1, x.shape[axis])
    return jnp.repeat(x[tuple(idx)], halo, axis=axis)


def _strip(x, axis, front: bool, halo: int):
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(0, halo) if front else slice(x.shape[axis] - halo, x.shape[axis])
    return x[tuple(idx)]


def exchange_axis(x: jnp.ndarray, halo: int, axis: int, axis_name: str) -> jnp.ndarray:
    """Pad ``x`` with ``halo`` neighbour rows/cols along ``axis``."""
    n = lax.axis_size(axis_name)
    i = lax.axis_index(axis_name)
    if n == 1:
        lo = _edge(x, axis, True, halo)
        hi = _edge(x, axis, False, halo)
        return jnp.concatenate([lo, x, hi], axis=axis)
    # halo that arrives from the lower-index neighbour (their trailing strip)
    fwd = [(k, k + 1) for k in range(n - 1)]
    bwd = [(k + 1, k) for k in range(n - 1)]
    from_lo = lax.ppermute(_strip(x, axis, False, halo), axis_name, fwd)
    from_hi = lax.ppermute(_strip(x, axis, True, halo), axis_name, bwd)
    lo = jnp.where(i == 0, _edge(x, axis, True, halo), from_lo)
    hi = jnp.where(i == n - 1, _edge(x, axis, False, halo), from_hi)
    return jnp.concatenate([lo, x, hi], axis=axis)


def halo_pad2d(x: jnp.ndarray, halo: int) -> jnp.ndarray:
    """Pad the trailing two axes with neighbour halos ((dy, dx) mesh axes).

    Exchanging the already-extended rows along dy fills the corners too.
    """
    x = exchange_axis(x, halo, -1, "dx")
    x = exchange_axis(x, halo, -2, "dy")
    return x
