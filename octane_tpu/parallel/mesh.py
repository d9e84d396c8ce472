"""Device-mesh construction and sharding specs for the image grid."""

from __future__ import annotations

from typing import Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(shape: Tuple[int, int] = None, devices=None) -> Mesh:
    """Create a 2-D ("dy", "dx") mesh over the available devices.

    With no ``shape``, uses (1, n_devices).  The devices of one host are
    joined all to all, so the shape follows the algorithm alone.
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (1, n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh(shape, ("dy", "dx"), axis_types=auto, devices=devices)


def image_sharding(mesh: Mesh) -> NamedSharding:
    """(C, H, W) images: channels replicated, H/W sharded."""
    return NamedSharding(mesh, P(None, "dy", "dx"))


def flow_sharding(mesh: Mesh) -> NamedSharding:
    """(H, W) flow fields."""
    return NamedSharding(mesh, P("dy", "dx"))
