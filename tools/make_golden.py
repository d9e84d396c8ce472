"""Generate the golden regression fixtures (run on CPU; commit the outputs).

1. tests/golden/variational_256.npz — ORACLE fixture: a 256^2 GOES-like
   pair solved by the loop-level NumPy oracle (tests/reference_impl.py,
   reference CUDA semantics) at the FULL default settings: kiters=4,
   liters=3, cgiters=30, 3 GNC steps (so the robust al1<1 coefficient
   path is engaged, unlike the 64^2 fixture's small crop), alpha=5,
   lambda=1, Zimmer normalization.  The matrix-free PCG stands in for the
   dense-matrix form (64 GB at this size); their row structure is
   identical (apply_stencil_np) and checked against dense_matrix in
   tests/test_golden.py.

2. tests/golden/product_512.npz — PRODUCT-LEVEL regression fixture: the
   U/V/U_raw/V_raw short planes of a full pipeline run (synthetic GOES
   pair -> flow -> pix2uv -> encoding) at default settings on CPU.  This
   is a regression net, not an oracle: it pins the product surface of the
   verified pipeline so a numerics change that moves products by more
   than short quantization noise fails CI at the level users see.

Usage: python tools/make_golden.py [--skip-oracle] [--skip-product]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
# match the test environment (tests/conftest.py): f64 navigation on CPU
jax.config.update("jax_enable_x64", True)

import numpy as np

GOLD = os.path.join(os.path.dirname(__file__), "..", "tests", "golden")


def goes_like_pair(hw, shift=(2.4, -1.1), seed=7):
    """Cloud-deck-like pair with hard edges + texture, normalized 0-255
    like the pipeline's band normalization (trimmed for oracle
    runtime)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)

    def scene(dx, dy):
        ax, ay = xx - dx, yy - dy
        img = (170.0
               + 50.0 * np.exp(-(((ax - hw / 3) ** 2 + (ay - hw / 2) ** 2)
                                 / (2 * (hw / 7.0) ** 2)))
               - 90.0 * np.exp(-(((ax - 2 * hw / 3) ** 2
                                  + (ay - hw / 3) ** 2)
                                 / (2 * (hw / 9.0) ** 2)))
               + 12.0 * np.sin(ax / 6.0) * np.cos(ay / 8.0)
               + 6.0 * np.sin(ax / 23.0 + ay / 17.0))
        return (np.clip(img, 0, 255)
                + rng.normal(0, 0.5, (hw, hw))).astype(np.float32)

    return scene(0.0, 0.0), scene(*shift)


def make_oracle_fixture():
    import reference_impl as ref

    hw = 256
    im1, im2 = goes_like_pair(hw)
    z = np.zeros((hw, hw), np.float32)
    u, v = ref.variational_flow_matfree(im1, im2, z, z, kiters=4)
    out = os.path.join(GOLD, "variational_256.npz")
    np.savez_compressed(out, im1=im1, im2=im2, u=u, v=v)
    print(f"wrote {out}  (median |u| {np.median(np.abs(u)):.3f}, "
          f"|v| {np.median(np.abs(v)):.3f})")


def make_product_fixture():
    import tempfile

    import h5py

    from tests.synth import make_goes_file

    h = w = 512
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)

    def scene(sx, sy):
        return (3000 + 8000 * np.exp(
            -(((xx - sx - w / 2) ** 2 + (yy - sy - h / 2) ** 2)
              / (2 * 60.0 ** 2)))
            + 1500 * np.sin((xx - sx) / 11.0) * np.cos((yy - sy) / 13.0)
        ).astype(np.int16)

    with tempfile.TemporaryDirectory() as td:
        f1 = make_goes_file(os.path.join(td, "g1.nc"), scene(0, 0), band=13)
        f2 = make_goes_file(os.path.join(td, "g2.nc"), scene(3.0, -1.5),
                            band=13, t=650000060.0)
        from octane_tpu.config import OFConfig
        from octane_tpu.pipeline import run_pipeline

        run_pipeline(f1, f2, OFConfig(), outdir=td)
        with h5py.File(os.path.join(td, "outfile.nc")) as f:
            planes = {k: f[k][()] for k in ("U", "V", "U_raw", "V_raw")}
    out = os.path.join(GOLD, "product_512.npz")
    np.savez_compressed(out, **planes)
    print(f"wrote {out}  (U mean {planes['U'].mean() * 0.01:.2f} m/s)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--skip-product", action="store_true")
    a = ap.parse_args()
    if not a.skip_oracle:
        make_oracle_fixture()
    if not a.skip_product:
        make_product_fixture()
