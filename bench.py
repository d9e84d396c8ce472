"""Benchmark: dense variational optical flow throughput on one device.

Measures the full coarse-to-fine solve (reference default settings:
3 GNC x 3 inner iterations, <=30 CG, alpha=5, lambda=1) at the BASELINE.md
config shapes and prints one JSON line:
  {"metric": "variational_flow_mpix_s", "value": ..., "unit": "Mpix/s",
   "platform": ..., "device_kind": ..., "device_count": ...}

  --config 1   512x512 CONUS band-13 crop, 3-level pyramid (CPU-runnable)
  --config 2   5008x3008 CONUS band-2 1-km, 5-level pyramid
  --config 3   5424x5424 full-disk band-13 2-km, 4-level pyramid  [default]
  --config 4   8192x8192 hybrid: patch-match init + variational refine
  --config 5   12-frame 500x500 mesoscale sequence with first-guess warm
               starts (value = end-to-end sequence Mpix/s)

The default headline is config 3: a REAL product shape (5424 is not a
power of two: 5424 = 16 x 339), not a synthetic size.

Throughput is measured at steady state, the production-serving condition:
K solves are dispatched back-to-back (inputs varied per rep so nothing can
be cached) and the per-pair time is the slope between a K-chain and a
2K-chain, which cancels the constant dispatch and readback latency.

Solver: ``--solver sor`` (default) runs 30 sweeps of red-black SOR
(omega=1.9); ``--solver pcg`` runs the reference-exact Jacobi-PCG
(identical math/stopping rule to oct_variational_optical_flow.cu:
1100-1183), which is the CLI's default.  Accuracy of SOR-30 against PCG-30:
docs/PARITY.md.
"""

import argparse
import json
import time

import numpy as np
import jax
import jax.numpy as jnp

from octane_tpu.utils.cache import use_compile_cache


def synth_pair(h, w, seed=0, shift=2.4):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def scene(s):
        return (
            120.0 * np.exp(-(((xx - s - w / 3) ** 2 + (yy - h / 3) ** 2)
                             / (2 * (w / 8) ** 2)))
            + 60.0 * np.sin((xx - s) / 9.0) * np.cos(yy / 7.0)
            + 50.0
            + rng.normal(0, 2.0, (h, w)).astype(np.float32)
        )

    return scene(0.0).astype(np.float32), scene(shift).astype(np.float32)


def steady_state_s(run_one, k=4, reps=3):
    """Per-dispatch seconds from the slope of a K-chain vs a 2K-chain."""
    def chain(n, base):
        s = jnp.float32(0)
        t0 = time.perf_counter()
        for i in range(n):
            s = s + run_one(base + i)
        float(s)
        return time.perf_counter() - t0

    chain(1, 999)  # warmup / compile
    t1 = min(chain(k, 1 + r * 100) for r in range(reps))
    t2 = min(chain(2 * k, 51 + r * 100) for r in range(reps))
    return (t2 - t1) / k


def bench_variational(h, w, kiters, k_chain=4, solver="sor"):
    from octane_tpu.config import OFConfig
    from octane_tpu.flow.variational import flow_program

    im1, im2 = synth_pair(h, w)
    cfg = OFConfig(kiters=kiters, alpha=5.0, lambda_=1.0, solver=solver)
    program = flow_program(cfg, (h, w), 1)
    g1 = jnp.asarray(im1[None])
    g2 = jnp.asarray(im2[None])
    z = jnp.zeros((h, w), jnp.float32)

    def run_one(i):
        u, v = program(g1, g2, z + jnp.float32(i) * 1e-6, z)
        return u[0, 0]

    dt = steady_state_s(run_one, k=k_chain)
    return (h * w / 1e6) / dt


def bench_hybrid(h, w, kiters, solver="sor"):
    """Config 4 proxy: patch-match initialization + variational refinement
    at the largest single-chip shape (the 21696^2 original is multi-host)."""
    from octane_tpu.config import OFConfig
    from octane_tpu.flow.patch_match import patch_match_flow
    from octane_tpu.flow.variational import flow_program

    im1, im2 = synth_pair(h, w)
    cfg = OFConfig(kiters=kiters, alpha=5.0, lambda_=1.0, solver=solver)
    program = flow_program(cfg, (h, w), 1)
    g1 = jnp.asarray(im1[None])
    g2 = jnp.asarray(im2[None])
    # the product -hybrid path runs patch-match WITHOUT a first guess (the
    # slice-based fast path; the guessed-origin variant is sector-scale
    # only, flow/patch_match.py guard) and feeds its flow to the
    # variational refinement; inputs are varied per rep via the image
    pm = jax.jit(lambda a, b: patch_match_flow(a, b, None, None, 2, 2))

    def run_one(i):
        u0, v0 = pm(g1[0], g2[0] + jnp.float32(i) * 1e-6)
        u, v = program(g1, g2, u0, v0)
        return u[0, 0]

    dt = steady_state_s(run_one, k=2)
    return (h * w / 1e6) / dt


def bench_sequence(h, w, nframes, solver="sor"):
    """Config 5: sequential pairs with first-guess warm starts."""
    from octane_tpu.config import OFConfig
    from octane_tpu.flow.variational import flow_program

    cfg = OFConfig(kiters=3, alpha=5.0, lambda_=1.0, lambdac=0.05,
                   solver=solver)
    program = flow_program(cfg, (h, w), 1)
    frames = [jnp.asarray(synth_pair(h, w, seed=i)[0][None])
              for i in range(nframes)]
    z = jnp.zeros((h, w), jnp.float32)

    def run_seq(base):
        u, v = z + jnp.float32(base) * 1e-6, z
        for i in range(nframes - 1):
            u, v = program(frames[i], frames[i + 1], u, v)
        return u[0, 0]

    dt = steady_state_s(run_seq, k=2)          # seconds per 11-pair sequence
    return ((nframes - 1) * h * w / 1e6) / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=int, default=3, choices=range(1, 6))
    ap.add_argument("--solver", default="sor", choices=("sor", "pcg"),
                    help="red-black SOR (default) or reference-exact PCG")
    args = ap.parse_args()
    s = args.solver
    use_compile_cache()

    if args.config == 1:
        mpix_s = bench_variational(512, 512, kiters=3, k_chain=6, solver=s)
        metric = "variational_flow_conus_crop_mpix_s"
    elif args.config == 2:
        mpix_s = bench_variational(5008, 3008, kiters=5, k_chain=3, solver=s)
        metric = "variational_flow_conus_band2_mpix_s"
    elif args.config == 3:
        mpix_s = bench_variational(5424, 5424, kiters=4, k_chain=3, solver=s)
        metric = "variational_flow_mpix_s"
    elif args.config == 4:
        mpix_s = bench_hybrid(8192, 8192, kiters=4, solver=s)
        metric = "hybrid_flow_mpix_s"
    else:
        mpix_s = bench_sequence(500, 500, nframes=12, solver=s)
        metric = "sequence_flow_mpix_s"

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": metric,
        "value": round(mpix_s, 3),
        "unit": "Mpix/s",
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }))


if __name__ == "__main__":
    main()
