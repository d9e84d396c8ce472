"""Stage times of the full-disk solve on the device JAX finds.

Times each XLA stage of the solve standalone at --size (default 5424^2, ABI
full disk at 2 km) with ``block_until_ready``, and prints each beside the
least bytes it must move (its byte floor) and the rate that implies:

  * pyramid downsample and zoom_in_flow (one pyramid step each way);
  * the warp of the 6-plane sample stack (6 gathered planes + u, v read);
  * the assembly, robust and quadratic (13 planes read; 10 written by a
    design that also emits SOR's reciprocal determinant, 9 here);
  * one PCG iteration (29.75 planes) and one red-black SOR sweep (14 planes
    robust, 10 quadratic), each as (t[30 iters] - t[1 iter]) / 29;
  * SRSAL, the 37x37 bilateral smoother (one pass would read u, v, CTH and
    write u, v: 5 planes);
  * a read-and-write pass over a 1 GiB array, the yardstick for those
    rates (host-timed like the stages, so one dispatch is included);
  * the whole flow_program per pair, pcg and sor.

It then takes one jax.profiler trace of the pcg program and prints the
device busy time, the idle share of the traced window and the ten longest
operations.  A number printed here is a measurement of the device it ran on
only; the first line names that device.

Run: python tools/profile_stages.py [--size 5424] [--trace-dir DIR]
"""

import argparse
import collections
import glob
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np
import jax
import jax.numpy as jnp

from octane_tpu.config import OFConfig
from octane_tpu.core.zoom import pyramid_downsample, zoom_in_flow, zoom_size
from octane_tpu.flow.cg import pcg_solve, sor_solve
from octane_tpu.flow.stencil import StencilSystem, apply_stencil, assemble, \
    warp_bilinear_dense
from octane_tpu.flow.variational import flow_program
from octane_tpu.post.srsal import srsal_smooth
from octane_tpu.utils.cache import use_compile_cache

PLANE = 4                                   # bytes per float32 pixel


def timed(fn, *args, reps=3):
    """Least wall seconds of ``reps`` calls after one warm-up call."""
    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def report(name, seconds, planes, hw):
    floor = planes * PLANE * hw
    print(f"{name:28s} {seconds * 1e3:10.3f} ms   floor {planes:6.2f} planes "
          f"= {floor / 1e6:9.1f} MB   {floor / seconds / 1e9:8.1f} GB/s",
          flush=True)


def make_system(h, w, quad, seed=1):
    rng = np.random.default_rng(seed)

    def arr(lo, hi):
        return jnp.asarray(rng.uniform(lo, hi, (h, w)).astype(np.float32))

    offd = ((jnp.float32(-1),) * 4 if quad
            else tuple(-arr(0.3, 1.0) for _ in range(4)))
    return StencilSystem(arr(4.5, 9.0), arr(-0.2, 0.2), arr(4.5, 9.0),
                         *offd, arr(-100, 100), arr(-100, 100))


def per_iteration(make_fn, arg):
    """Seconds per loop iteration, (t[30] - t[1]) / 29: the difference
    cancels the dispatch and the work outside the loop."""
    t30 = timed(jax.jit(make_fn(30)), arg)
    t1 = timed(jax.jit(make_fn(1)), arg)
    return (t30 - t1) / 29


def trace_summary(trace_dir):
    """Device busy time, idle share of the window and the longest ops."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        print("trace: no trace file written")
        return
    planes = [p for p in ProfileData.from_file(paths[-1]).planes
              if p.name.startswith("/device:")]
    if not planes:
        print("trace: no device plane (device time not measured)")
    for plane in planes:
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or lines
        events = [(e.start_ns, e.duration_ns, e.name)
                  for ln in ops for e in ln.events]
        if not events:
            continue
        busy, end = 0.0, -1.0
        for s, d, _ in sorted(events):
            if s + d > end:
                busy += s + d - max(s, end)
                end = s + d
        window = max(s + d for s, d, _ in events) - min(s for s, _, _ in events)
        by_name = collections.Counter()
        for _, d, n in events:
            by_name[n] += d
        print(f"trace {plane.name}: busy {busy / 1e6:.3f} ms of a "
              f"{window / 1e6:.3f} ms window (idle share "
              f"{1 - busy / window:.4f}); longest ops:")
        for n, d in by_name.most_common(10):
            print(f"    {d / 1e6:10.3f} ms  {n}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=5424)
    ap.add_argument("--trace-dir", default=None,
                    help="where the trace is written (default: a new "
                         "temporary directory)")
    args = ap.parse_args()
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="profile_stages_")
    use_compile_cache()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x {len(jax.devices())}; "
          f"size {args.size}^2", flush=True)

    n = args.size
    h = w = n
    hw = h * w
    rng = np.random.default_rng(0)

    def field(lo, hi, shape=(h, w)):
        return jnp.asarray(rng.uniform(lo, hi, shape).astype(np.float32))

    img = field(0, 255, (1, h, w))
    u, v = field(-2, 2), field(-2, 2)
    stack6 = field(-1, 1, (6, h, w))

    big = jnp.ones((16384, 16384), jnp.float32)
    t = timed(jax.jit(lambda a: a * 1.0001), big, reps=10)
    report("copy 16384^2 (read+write)", t, 2.0, big.size)
    del big

    t = timed(jax.jit(lambda a: pyramid_downsample(a, 0.5)), img)
    report("pyramid_downsample 1/2", t, 1.25, hw)
    half = field(-2, 2, (zoom_size(h, 0.5), zoom_size(w, 0.5)))
    t = timed(jax.jit(lambda a: zoom_in_flow(a, (h, w), 0.5)), half)
    report("zoom_in_flow x2", t, 1.25, hw)

    t = timed(jax.jit(lambda s, a, b: sum(
        jnp.sum(x) for x in warp_bilinear_dense(s, a, b))), stack6, u, v)
    report("warp 6-plane stack", t, 8.0, hw)

    for name, al1_static, writes in (("assemble robust", None, 9.0),
                                     ("assemble quad", 1.0, 5.0)):
        al1 = jnp.float32(0.5 if al1_static is None else 1.0)

        def asm(g, stk, uu, vv, _al1=al1, _s=al1_static):
            return assemble(g, g, g, g, g, g, g, g, g, uu, vv, uu, vv,
                            _al1, jnp.float32(5.0), jnp.float32(0.2),
                            jnp.float32(0.0), True, stack=stk,
                            al1_static=_s)
        report(name, timed(jax.jit(asm), img, stack6, u, v), 13.0 + writes, hw)

    zero = jnp.float32(0.0)
    for quad in (False, True):
        sysm = make_system(h, w, quad)
        t = per_iteration(lambda it: lambda s: pcg_solve(
            lambda a, b: apply_stencil(s, a, b),
            s.a1, s.a4, s.bu, s.bv, zero, it), sysm)
        # quadratic systems carry the 4 off-diagonals as scalars
        report(f"pcg iteration {'quad' if quad else 'robust'}", t,
               25.75 if quad else 29.75, hw)
        t = per_iteration(lambda it: lambda s: sor_solve(s, zero, it), sysm)
        report(f"sor sweep {'quad' if quad else 'robust'}", t,
               10.0 if quad else 14.0, hw)

    cth = field(3000, 9000)
    report("srsal 37x37", timed(jax.jit(srsal_smooth), u, v, cth, reps=1),
           5.0, hw)

    img2 = jnp.roll(img, 3, axis=2)
    z = jnp.zeros((h, w), jnp.float32)
    for solver in ("pcg", "sor"):
        program = flow_program(OFConfig(solver=solver), (h, w), 1)
        t = timed(program, img, img2, z, z, reps=2)
        print(f"{'flow_program ' + solver:28s} {t * 1e3:10.3f} ms/pair   "
              f"{hw / 1e6 / t:8.3f} Mpix/s", flush=True)

    program = flow_program(OFConfig(), (h, w), 1)
    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(program(img, img2, z, z))
    print(f"trace written to {trace_dir}")
    trace_summary(trace_dir)
    stats = dev.memory_stats() or {}
    print(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'not reported')}")


if __name__ == "__main__":
    main()
