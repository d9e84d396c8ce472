"""The bilinear warp (flow.stencil.warp_bilinear_dense) against the
loop-level NumPy oracle (reference_impl.warp_bilinear).

The warp is an unbounded gather: any displacement samples exactly, with the
reference's position clamps at the image edges and the clamp flags that
zero the warped gradients.  The flow fields cover the cases that matter at
the edges and at reach.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import reference_impl as ref
from octane_tpu.flow.stencil import warp_bilinear_dense

H, W = 40, 56


def _flow(case, rng):
    jj, ii = np.mgrid[0:H, 0:W].astype(np.float32)
    jitter = rng.uniform(-0.9, 0.9, (2, H, W)).astype(np.float32)
    if case == "small_offset":
        u, v = jitter * 2.0
    elif case == "bias_20px":
        u, v = 20.0 + jitter[0], -20.0 + jitter[1]
    elif case == "clamped_edge_rows":
        u, v = jitter * 3.0
        v[:3] -= 50.0                       # top rows sample above the image
        v[-3:] += 50.0                      # bottom rows sample below it
    elif case == "shear":
        # a row-to-row spread far wider than any fixed sampling window
        u = 6.0 * (jj - H / 2) + jitter[0]
        v = 0.5 * (ii - W / 2) + jitter[1]
    else:                                   # sub-pixel extrapolation bands
        u, v = jitter
        u[:, -1] = 0.7                      # px in (W-1, W): not clamped
        v[-1, :] = 0.4                      # py in (H-1, H)
    return np.asarray(u, np.float32), np.asarray(v, np.float32)


@pytest.mark.parametrize("case", ["small_offset", "bias_20px",
                                  "clamped_edge_rows", "shear",
                                  "extrapolation_bands"])
def test_warp_matches_oracle(case):
    rng = np.random.default_rng(3)
    fields = rng.normal(0, 1, (6, H, W)).astype(np.float32)
    u, v = _flow(case, rng)
    want, bx, by = ref.warp_bilinear(fields, u, v)
    got, gbx, gby = warp_bilinear_dense(
        jnp.asarray(fields), jnp.asarray(u), jnp.asarray(v))
    np.testing.assert_array_equal(np.asarray(gbx), bx)
    np.testing.assert_array_equal(np.asarray(gby), by)
    # same taps and weights; only multiply-add contraction may differ
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-5)
    if case == "clamped_edge_rows":
        assert by[:3].all() and by[-3:].all()
