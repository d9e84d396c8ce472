"""Jacobi-PCG (flow.cg.pcg_solve) against the matrix-free oracle PCG.

reference_impl.pcg_matfree is the reference's in-kernel PCG
(oct_variational_optical_flow.cu:1100-1183) over the same operator; the
two differ only in the order of the dot products' sums.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import reference_impl as ref
from octane_tpu.flow.cg import pcg_solve
from octane_tpu.flow.stencil import StencilSystem, _mask_padded, apply_stencil

FIELDS = ("a1", "a2", "a4", "a5", "a6", "a7", "a8", "bu", "bv")


def _fields(h, w, quad, seed=1):
    rng = np.random.default_rng(seed)

    def arr(lo, hi):
        return rng.uniform(lo, hi, (h, w)).astype(np.float32)

    diag = (arr(4.5, 9.0), arr(4.5, 9.0))
    a2 = arr(-0.2, 0.2)
    if quad:
        offd = [np.full((h, w), -1.0, np.float32)] * 4
    else:
        offd = [-arr(0.3, 1.0) for _ in range(4)]
    rhs = (arr(-100, 100), arr(-100, 100))
    return dict(zip(FIELDS, [diag[0], a2, diag[1], *offd, *rhs]))


def _system(A, quad):
    fields = [jnp.asarray(A[k]) for k in FIELDS]
    if quad:
        fields[3:7] = [jnp.float32(-1.0)] * 4
    return StencilSystem(*fields)


def _solve(s, iters, true_hw=None):
    return pcg_solve(lambda a, b: apply_stencil(s, a, b, true_hw=true_hw),
                     s.a1, s.a4, s.bu, s.bv, jnp.float32(1e-8), iters)


@pytest.mark.parametrize("quad", [True, False])
@pytest.mark.parametrize("shape", [(16, 24), (13, 19)])
def test_pcg_matches_oracle(shape, quad):
    A = _fields(*shape, quad)
    du, dv = _solve(_system(A, quad), 12)
    wu, wv = ref.pcg_matfree(A, A["bu"], A["bv"], 1e-8, 12)
    scale = float(np.abs(wu).max())
    d = max(float(np.abs(np.asarray(du) - wu).max()),
            float(np.abs(np.asarray(dv) - wv).max()))
    # summation order of the dots differs: float-level budget
    assert d / scale < 1e-4, f"rel diff {d / scale:.2e} ({shape}, quad={quad})"


def test_padded_rows_stay_decoupled():
    """With trailing mesh-divisibility padding the padded rows hold exactly
    zero residual and zero solution -- any leakage would corrupt alpha and
    beta for the true rows, so the true pixels must match the unpadded
    solve."""
    h, w, hp, wp = 13, 19, 16, 24
    A = _fields(h, w, quad=True, seed=3)
    padded = {k: np.pad(a, ((0, hp - h), (0, wp - w)), mode="edge")
              for k, a in A.items()}
    s = _mask_padded(_system(padded, True), h, w, hp, wp)
    du, dv = _solve(s, 6, true_hw=(h, w))
    wu, wv = ref.pcg_matfree(A, A["bu"], A["bv"], 1e-8, 6)
    du, dv = np.asarray(du), np.asarray(dv)
    for x in (du, dv):
        assert not x[h:].any() and not x[:, w:].any()
    scale = float(np.abs(wu).max())
    d = max(np.abs(du[:h, :w] - wu).max(), np.abs(dv[:h, :w] - wv).max())
    assert d < 1e-4 * scale, d / scale
