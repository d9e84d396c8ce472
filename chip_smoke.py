"""Smoke test of the solver on NVIDIA GPUs, through the entry points users call.

Run from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # only the sharded full-disk phase, 4 cards

Phases, in one process (a failing phase exits nonzero; nothing falls back to
the CPU or to a reference):

1. device: JAX's first device must be a GPU.
2. oracle fixtures: ``flow_program`` on the NumPy-oracle fixtures
   (tests/golden/variational_64.npz at kiters 3, variational_256.npz at
   kiters 4 with pcg and sor) within the EPE bounds of tests/test_golden.py.
3. full disk: ABI band 13 at 2 km (5424^2), default settings, on the
   ``bench.synth_pair`` inputs.  pcg on the GPU against the same program on
   the CPU device of this process, and sor against pcg on the GPU.
4. product path: ``cli.main`` on a synthesized 5424^2 L1b pair plus CTH with
   -i1cth -srsal -interp, and a 512^2 run against tests/golden/product_512.npz.
   Without h5py the same stages run in memory (navcal -> compute_flow with
   SRSAL -> interpolate_frame).
5. --four-cards: ``sharded_variational_flow`` at 5424^2 on a 2x2 mesh against
   ``flow_program`` on one card, and the mesh's time in collectives (their
   share of device time and the exposed part), read from a profiler trace.

Every program prints its compile seconds and ``memory_analysis()``; every
parity number is printed beside its bound.  Navigation runs in float64 (x64
on), as it did when the product fixture was made.  The last line of standard
output is one JSON object naming the device JAX reports.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import jax
import jax.numpy as jnp

from octane_tpu.config import OFConfig
from octane_tpu.flow.variational import flow_program
from octane_tpu.utils.cache import use_compile_cache

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
FULL_DISK = 5424                      # ABI full disk, 2-km bands
T0 = 650000000.0                      # J2000 seconds of the first image
FULL_DISK_CADENCE = 600.0             # Mode-6 full-disk scan period (s)
SHIFT = (3.0, -1.5)                   # synthetic scene motion (px)
COLLECTIVE = re.compile(
    r"nccl|all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all",
    re.IGNORECASE)


def require_gpu(devices) -> None:
    """Refuse to run anywhere but on a GPU (exit code 1, no result line)."""
    found = devices[0].platform if devices else "none"
    if found != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX's first device is {found}")


def last_line(devices) -> str:
    """The JSON result line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


def check(label: str, value: float, bound: float) -> None:
    ok = value < bound
    print(f"  {label}: {value:.6g} (bound < {bound:g}) "
          f"{'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise SystemExit(f"parity bound failed: {label}")


def print_card() -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    print("nvidia-smi name, power.limit:")
    for line in out.strip().splitlines():
        print(line)


def compile_timed(label, jitted, *args):
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    dt = time.perf_counter() - t0
    m = compiled.memory_analysis()
    mem = "none" if m is None else (
        f"arguments {m.argument_size_in_bytes} B, "
        f"outputs {m.output_size_in_bytes} B, "
        f"temp {m.temp_size_in_bytes} B, "
        f"code {m.generated_code_size_in_bytes} B")
    print(f"  {label}: compile {dt:.3f} s; memory_analysis: {mem}", flush=True)
    return compiled


def run_timed(label, fn, *args):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    print(f"  {label}: {time.perf_counter() - t0:.3f} s "
          "(one call, not a benchmark)", flush=True)
    return out


def solve(cfg, im1, im2, label, device):
    """flow_program on ``device``: compiled, timed, returned as NumPy."""
    h, w = im1.shape
    z = np.zeros((h, w), np.float32)
    args = [jax.device_put(np.asarray(a, np.float32), device)
            for a in (im1[None], im2[None], z, z)]
    compiled = compile_timed(label, flow_program(cfg, (h, w), 1), *args)
    u, v = run_timed(label, compiled, *args)
    return np.asarray(u), np.asarray(v)


def endpoint_error(u, v, u_ref, v_ref):
    return np.sqrt((np.asarray(u, np.float64) - u_ref) ** 2
                   + (np.asarray(v, np.float64) - v_ref) ** 2)


def print_peak(devices) -> None:
    for d in devices:
        stats = d.memory_stats() or {}
        print(f"  peak_bytes_in_use[{d.id}]: "
              f"{stats.get('peak_bytes_in_use', 'not reported')}", flush=True)


def phase_oracle_fixtures(device) -> None:
    print("phase 2: oracle fixtures", flush=True)
    for name, kiters, solvers in (("variational_64", 3, ("pcg",)),
                                  ("variational_256", 4, ("pcg", "sor"))):
        g = np.load(os.path.join(GOLDEN, name + ".npz"))
        for solver in solvers:
            label = f"{name} {solver}"
            u, v = solve(OFConfig(kiters=kiters, solver=solver),
                         g["im1"], g["im2"], label, device)
            epe = endpoint_error(u, v, g["u"], g["v"])
            check(f"{label} mean EPE vs oracle (px)", epe.mean(), 0.01)
            check(f"{label} max EPE vs oracle (px)", epe.max(), 0.1)


def phase_full_disk(device, n: int = FULL_DISK) -> None:
    from bench import synth_pair

    print(f"phase 3: full disk {n}^2, band 13 at 2 km, default settings",
          flush=True)
    im1, im2 = synth_pair(n, n)
    cfg = OFConfig()                   # pcg, kiters 4, liters 3, cgiters 30
    u_g, v_g = solve(cfg, im1, im2, f"{n}^2 pcg on {device.platform}", device)
    if not (np.isfinite(u_g).all() and np.isfinite(v_g).all()):
        raise SystemExit("full-disk pcg flow is not finite")

    t0 = time.perf_counter()
    cpu = jax.devices("cpu")[0]
    u_c, v_c = solve(cfg, im1, im2, f"{n}^2 pcg on cpu", cpu)
    print(f"  cpu leg (set-up): {time.perf_counter() - t0:.1f} s", flush=True)
    epe = endpoint_error(u_g, v_g, u_c, v_c)
    check("pcg gpu vs cpu mean EPE (px)", epe.mean(), 0.01)
    check("pcg gpu vs cpu p99 EPE (px)", float(np.percentile(epe, 99)), 0.05)
    print(f"  pcg gpu vs cpu max EPE (px): {epe.max():.6g} (reported)")

    u_s, v_s = solve(cfg.replace(solver="sor"), im1, im2,
                     f"{n}^2 sor on {device.platform}", device)
    epe = endpoint_error(u_s, v_s, u_g, v_g)
    check("sor vs pcg (gpu) mean EPE (px)", epe.mean(), 0.02)
    print(f"  sor vs pcg (gpu) p99 / max EPE (px): "
          f"{np.percentile(epe, 99):.6g} / {epe.max():.6g} (reported)")
    print_peak([device])


def synth_counts(n: int, shift=(0.0, 0.0), seed=0) -> np.ndarray:
    """Band-13-like int16 counts: a warm feature, texture, and noise drawn
    from ``seed``.  With n = 512 and seed=None this is the scene of
    tests/golden/product_512.npz."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    sx, sy = shift
    s = n / 512.0
    img = (3000 + 8000 * np.exp(-(((xx - sx - n / 2) ** 2
                                   + (yy - sy - n / 2) ** 2)
                                  / (2 * (60.0 * s) ** 2)))
           + 1500 * np.sin((xx - sx) / 11.0) * np.cos((yy - sy) / 13.0))
    if seed is not None:
        img = img + np.random.default_rng(seed).normal(0, 4.0, (n, n))
    return img.astype(np.int16)


def synth_cth(n: int) -> np.ndarray:
    """Smooth cloud-top heights (m) with a few km of relief."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32)
    return (6000 + 3000 * np.sin(xx / 211.0) * np.cos(yy / 173.0)
            ).astype(np.float32)


def check_flow(label: str, u: np.ndarray, v: np.ndarray) -> None:
    """Mean displacement of the central square against the synthetic
    motion.  At full-disk size the corners lie beyond the Earth's limb,
    where navcal zeroes the image and the flow is zero; the central square
    is on the disk at every size."""
    if not (np.isfinite(u).all() and np.isfinite(v).all()):
        raise SystemExit(f"{label}: flow is not finite")
    q = u.shape[0] // 4
    c = np.s_[q:-q, q:-q]
    check(f"{label} |mean u - {SHIFT[0]}| (px)",
          abs(float(u[c].mean()) - SHIFT[0]), 0.1)
    check(f"{label} |mean v - ({SHIFT[1]})| (px)",
          abs(float(v[c].mean()) - SHIFT[1]), 0.1)


def phase_product(n: int = FULL_DISK) -> None:
    print("phase 4: product path", flush=True)
    try:
        import h5py
    except ImportError:
        print("file_io: not run (h5py absent)")
        product_in_memory(n)
        return
    from octane_tpu import cli
    from tests.synth import make_cth_file, make_goes_file

    with tempfile.TemporaryDirectory() as td:
        f1 = make_goes_file(os.path.join(td, "g1.nc"), synth_counts(n),
                            band=13, t=T0)
        f2 = make_goes_file(os.path.join(td, "g2.nc"),
                            synth_counts(n, SHIFT, seed=1), band=13,
                            t=T0 + FULL_DISK_CADENCE)
        fc = make_cth_file(os.path.join(td, "cth.nc"), synth_cth(n))
        out, interp = os.path.join(td, "out"), os.path.join(td, "interp")
        t0 = time.perf_counter()
        cli.main(["-i1", f1, "-i2", f2, "-i1cth", fc, "-srsal", "-interp",
                  "-deltat", str(FULL_DISK_CADENCE / 2), "-o", out,
                  "-interploc", interp])
        print(f"  cli {n}^2 -i1cth -srsal -interp: "
              f"{time.perf_counter() - t0:.3f} s (one call, compile included)")
        with h5py.File(os.path.join(out, "outfile.nc")) as f:
            u = np.asarray(f["U_raw"][()], np.float64) * 0.01
            v = np.asarray(f["V_raw"][()], np.float64) * 0.01
            ctp = np.asarray(f["CTP"][()]) if "CTP" in f else None
        check_flow(f"product {n}^2", u, v)
        if ctp is None:
            raise SystemExit("product has no CTP plane")
        frames = sorted(glob.glob(os.path.join(interp, "*.nc")))
        print(f"  interpolated frames written: {len(frames)}")
        if not frames:
            raise SystemExit("no interpolated frame was written")

        want = np.load(os.path.join(GOLDEN, "product_512.npz"))
        f1 = make_goes_file(os.path.join(td, "p1.nc"),
                            synth_counts(512, seed=None), band=13)
        f2 = make_goes_file(os.path.join(td, "p2.nc"),
                            synth_counts(512, SHIFT, seed=None), band=13,
                            t=T0 + 60.0)
        out512 = os.path.join(td, "out512")
        cli.main(["-i1", f1, "-i2", f2, "-o", out512])
        with h5py.File(os.path.join(out512, "outfile.nc")) as f:
            for var in ("U", "V", "U_raw", "V_raw"):
                got = np.asarray(f[var][()], np.int32)
                d = np.abs(got - np.asarray(want[var], np.int32))
                check(f"product 512^2 {var} max |short - fixture| (counts)",
                      float(d.max()), 2.0)
                print(f"  product 512^2 {var} exact shorts: "
                      f"{(d == 0).mean():.6f} (reported)")


def product_in_memory(n: int) -> None:
    """navcal -> compute_flow with SRSAL -> interpolate_frame, on scenes
    built in memory with tests/synth.py's navigation constants."""
    from octane_tpu.core.normalize import band_min_max
    from octane_tpu.flow.dispatcher import compute_flow
    from octane_tpu.io.datamodel import NavConstants, Scene
    from octane_tpu.nav.goes import navcal_goes
    from octane_tpu.post.temporal import interpolate_frame

    scale = 5.6e-05
    nav = NavConstants(
        grid="goes", nx=n, ny=n, x_scale=scale, x_offset=-scale * (n / 2 - 0.5),
        y_scale=-scale, y_offset=scale * (n / 2 - 0.5), lpo=-75.0,
        lam0=-75.0 * math.pi / 180.0, rad_scale=(0.01, 1.0, 1.0),
        rad_offset=(-0.5, 0.0, 0.0), fk1=(10803.3, 0.0, 0.0),
        fk2=(1392.74, 0.0, 0.0), bc1=(0.07544, 0.0, 0.0),
        bc2=(0.99975, 0.0, 0.0), kap1=(0.0015, 0.0, 0.0),
        max_x=n, max_y=n, max_xc=n, max_yc=n)
    vmin, vmax = band_min_max(13)
    x = np.arange(n, dtype=np.int16)
    scenes = []
    t0 = time.perf_counter()
    for counts, t in ((synth_counts(n), T0),
                      (synth_counts(n, SHIFT, seed=1), T0 + FULL_DISK_CADENCE)):
        data, lat, lon = navcal_goes(
            jnp.asarray(counts), jnp.asarray(x), jnp.asarray(x), nav,
            channel=0, cal="RAW", norm_min=vmin, norm_max=vmax)
        scenes.append(Scene(
            nav=dataclasses.replace(nav),
            data=np.asarray(data, np.float32)[None], t=t,
            band=(13, 0, 0), x=x, y=x, raw_counts=counts[None],
            lat=np.asarray(lat), lon=np.asarray(lon),
            norm_ranges=((float(vmin), float(vmax)),) * 3))
    s1, s2 = scenes
    s1.cth = synth_cth(n)
    cfg = OFConfig(do_cth=True, do_srsal=True, do_interp=True)
    compute_flow(s1, s2, cfg)
    check_flow(f"in-memory {n}^2", s1.u_pix, s1.v_pix)
    if not np.isfinite(np.asarray(s1.u_wind, np.float64)).all():
        raise SystemExit("winds are not finite")
    img, _ = interpolate_frame(jnp.asarray(s1.u_pix), jnp.asarray(s1.v_pix),
                               jnp.asarray(s1.data), jnp.asarray(s2.data), 0.5)
    if not np.isfinite(np.asarray(img)).all():
        raise SystemExit("interpolated frame is not finite")
    print(f"  navcal -> flow + SRSAL -> interpolation: "
          f"{time.perf_counter() - t0:.3f} s (one call, compile included)")


def _union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, -1
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def collective_times(events):
    """(busy, collective, exposed collective) nanoseconds of one device's
    (name, start_ns, duration_ns) op events.  A collective kernel also runs
    while it waits for its peers; its exposed part is the time during which
    no other operation ran on that device."""
    coll, other = [], []
    for name, start, dur in events:
        (coll if COLLECTIVE.search(name) else other).append(
            (start, start + dur))
    busy = _union_ns(coll + other)
    return busy, _union_ns(coll), busy - _union_ns(other)


def collective_share(trace_dir: str) -> str:
    """collective_times for each GPU of a profiler trace, as text."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        return "not measured (no trace file)"
    parts = []
    for plane in ProfileData.from_file(paths[0]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or lines
        b, c, x = collective_times((e.name, e.start_ns, e.duration_ns)
                                   for ln in ops for e in ln.events)
        if b:
            parts.append(f"{plane.name}: collectives {c / 1e6:.3f} of "
                         f"{b / 1e6:.3f} ms busy ({c / b:.4f}), exposed "
                         f"{x / 1e6:.3f} ms")
    return "; ".join(parts) if parts else "not measured (no GPU plane)"


def phase_four_cards(n: int = FULL_DISK) -> None:
    from bench import synth_pair
    from octane_tpu.parallel.mesh import flow_sharding, image_sharding, \
        make_mesh
    from octane_tpu.parallel.sharded import padded_global_shape, \
        sharded_flow_program, sharded_variational_flow

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--four-cards needs 4 GPUs; JAX sees {len(devices)}")
    print(f"phase 5: sharded full disk {n}^2 on a 2x2 mesh", flush=True)
    mesh = make_mesh((2, 2), devices[:4])
    cfg = OFConfig()
    im1, im2 = synth_pair(n, n)
    z = np.zeros((n, n), np.float32)

    u1, v1 = solve(cfg, im1, im2, f"{n}^2 pcg on one card", devices[0])

    shape = padded_global_shape((n, n), cfg, (2, 2)) or (n, n)
    true_shape = (n, n) if shape != (n, n) else None
    f32 = jnp.float32
    specs = (jax.ShapeDtypeStruct((1,) + shape, f32,
                                  sharding=image_sharding(mesh)),) * 2 + (
        jax.ShapeDtypeStruct(shape, f32, sharding=flow_sharding(mesh)),) * 2
    compile_timed(f"{n}^2 pcg sharded 2x2",
                  sharded_flow_program(cfg, shape, 1, mesh, true_shape),
                  *specs)

    def mesh_solve():
        return sharded_variational_flow(im1, im2, z, z, cfg, mesh)

    run_timed(f"{n}^2 pcg sharded 2x2, first call", mesh_solve)
    with tempfile.TemporaryDirectory() as td:
        with jax.profiler.trace(td):
            u, v = run_timed(f"{n}^2 pcg sharded 2x2, traced call", mesh_solve)
        share = collective_share(td)
    print(f"  collectives in the mesh's device time: {share}")
    epe = endpoint_error(np.asarray(u), np.asarray(v), u1, v1)
    check("sharded 2x2 vs one card mean EPE (px)", epe.mean(), 0.01)
    check("sharded 2x2 vs one card max EPE (px)", epe.max(), 0.1)
    print_peak(devices[:4])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded full-disk phase on 4 GPUs")
    a = ap.parse_args(argv)

    devices = jax.devices()
    require_gpu(devices)
    print_card()
    print(f"jax {jax.__version__}; devices: {len(devices)} x "
          f"{devices[0].device_kind}", flush=True)
    jax.config.update("jax_enable_x64", True)
    print(f"compile cache: {use_compile_cache()}")
    try:
        import h5py
        print(f"h5py: {h5py.__version__}")
    except ImportError:
        print("h5py: absent")

    if a.four_cards:
        phase_four_cards()
    else:
        gpu = devices[0]
        phase_oracle_fixtures(gpu)
        phase_full_disk(gpu)
        phase_product()
        print_peak([gpu])
    print(last_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
