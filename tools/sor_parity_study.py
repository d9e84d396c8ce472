"""One-off study: where does the SOR-30 vs PCG-30 max EPE live, and how
converged is each path there?  (run manually: python tools/sor_parity_study.py)

Outputs the numbers behind docs/PARITY.md's budget-basis argument."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from octane_tpu.config import OFConfig
from octane_tpu.flow.variational import flow_program
from octane_tpu.utils.cache import use_compile_cache


def run(cfg, im1, im2):
    hw = im1.shape[0]
    z = jnp.zeros((hw, hw), jnp.float32)
    u, v = flow_program(cfg, (hw, hw), 1)(
        jnp.asarray(im1[None]), jnp.asarray(im2[None]), z, z)
    return np.asarray(u), np.asarray(v)


def stats(u1, v1, u2, v2, label):
    epe = np.sqrt((u1 - u2) ** 2 + (v1 - v2) ** 2)
    print(f"{label}: mean {epe.mean():.5f} p99 "
          f"{np.percentile(epe, 99):.5f} max {epe.max():.5f} "
          f"argmax {np.unravel_index(epe.argmax(), epe.shape)}")
    return epe


def main():
    use_compile_cache()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind}")
    hw = 1356
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    rng = np.random.default_rng(3)
    im1 = (120 * np.exp(-(((xx - 400) ** 2 + (yy - 500) ** 2) / 9000.0))
           + 50 * np.sin(xx / 9.0) * np.cos(yy / 7.0) + 60
           + rng.normal(0, 2, (hw, hw))).astype(np.float32)
    im2 = (120 * np.exp(-(((xx - 402.4) ** 2 + (yy - 500) ** 2) / 9000.0))
           + 50 * np.sin((xx - 2.4) / 9.0) * np.cos(yy / 7.0) + 60
           + rng.normal(0, 2, (hw, hw))).astype(np.float32)

    up30, vp30 = run(OFConfig(kiters=4), im1, im2)
    up100, vp100 = run(OFConfig(kiters=4, cgiters=100), im1, im2)
    us30, vs30 = run(OFConfig(kiters=4, solver="sor"), im1, im2)

    e_ss = stats(us30, vs30, up30, vp30, "sor30  vs pcg30 ")
    e_pc = stats(up30, vp30, up100, vp100, "pcg30  vs pcg100")
    e_sc = stats(us30, vs30, up100, vp100, "sor30  vs pcg100")

    j, i = np.unravel_index(e_ss.argmax(), e_ss.shape)
    print(f"at sor-vs-pcg argmax ({j},{i}): |pcg30-pcg100| = "
          f"{e_pc[j, i]:.5f}, |sor30-pcg100| = {e_sc[j, i]:.5f}")
    # how many pixels exceed 0.1 px, and are they the unconverged ones?
    m = e_ss > 0.1
    print(f"pixels with sor-vs-pcg EPE > 0.1: {m.sum()} "
          f"({m.mean() * 100:.5f}%); at those pixels pcg30-vs-pcg100 "
          f"mean {e_pc[m].mean() if m.any() else 0:.5f}")

    for omega, iters in ((1.9, 40), (1.8, 30), (1.95, 30)):
        u, v = run(OFConfig(kiters=4, solver="sor", sor_omega=omega,
                            cgiters=iters), im1, im2)
        stats(u, v, up30, vp30, f"sor{iters} w={omega} vs pcg30 ")


if __name__ == "__main__":
    main()
