"""What keeps the program portable to a GPU, checked on the CPU.

The resampling matmuls must request float32-exact products (a GPU may
otherwise run them in TF32), the compile cache must follow
JAX_COMPILATION_CACHE_DIR, the package must hold no backend-specific
kernels or branches, and chip_smoke.py must refuse any device but a GPU.
"""

import os
import re
import types

import jax
import jax.numpy as jnp
import pytest

import chip_smoke
from octane_tpu.core.zoom import pyramid_downsample, zoom_in_flow
from octane_tpu.utils import cache

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "octane_tpu")


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    return [eqn.params["precision"] for eqn in jaxpr.jaxpr.eqns
            if eqn.primitive.name == "dot_general"]


@pytest.mark.parametrize("resample", ["pyramid_downsample", "zoom_in_flow"])
def test_resampling_matmuls_request_highest_precision(resample):
    if resample == "pyramid_downsample":
        fn = lambda a: pyramid_downsample(a, 0.5)  # noqa: E731
        args = (jnp.ones((1, 24, 20), jnp.float32),)
    else:
        fn = lambda a: zoom_in_flow(a, (24, 20), 0.5)  # noqa: E731
        args = (jnp.ones((12, 10), jnp.float32),)
    precisions = _dot_precisions(fn, *args)
    assert len(precisions) == 2
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    assert all(p == highest for p in precisions), precisions


def test_compile_cache_follows_environment(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it and nothing is set."""
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert cache.use_compile_cache() == "/elsewhere/cache"
    assert calls == []


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(os.path.dirname(PACKAGE), ".jax_cache")
    assert cache.use_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


def test_package_has_no_backend_specific_code():
    pattern = re.compile(r"pallas|default_backend\(|use_pallas|"
                         r"OCTANE_PALLAS_INTERPRET|jax_platforms")
    hits = []
    for root, _, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    for i, line in enumerate(f, 1):
                        if pattern.search(line):
                            hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_chip_smoke_refuses_the_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu(jax.devices())
    assert e.value.code not in (None, 0)
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])


def test_chip_smoke_last_line():
    card = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    line = chip_smoke.last_line([card] * 4)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100", "count": 4}}')


def test_chip_smoke_collective_times():
    """Busy time is the union of all ops; the exposed collective time is
    the part of it no other op covers."""
    events = [("fusion.1", 0, 10), ("all-reduce.2", 5, 15),
              ("fusion.3", 15, 3), ("ncclAllReduceKernel", 30, 5)]
    busy, coll, exposed = chip_smoke.collective_times(events)
    assert (busy, coll, exposed) == (25, 20, 12)
