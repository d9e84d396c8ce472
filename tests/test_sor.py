"""Red-black SOR (flow.cg.sor_solve) against the loop-level oracle.

The oracle (reference_impl.sor_redblack) visits pixels one at a time in
float32, so the two agree to float round-off, not bitwise: XLA evaluates
the same sums in another order and may contract multiply-adds.  The bound
below is relative to the iterate's scale; a wrong neighbour, mirror,
coefficient, colour or sweep count shows up at >= 1e-2.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import reference_impl as ref
from octane_tpu.flow.cg import sor_solve
from octane_tpu.flow.stencil import StencilSystem, _mask_padded, apply_stencil

FIELDS = ("a1", "a2", "a4", "a5", "a6", "a7", "a8", "bu", "bv")


def _make_sys(h, w, quad, seed=0):
    rng = np.random.default_rng(seed)

    def f(lo, hi):
        return rng.uniform(lo, hi, (h, w)).astype(np.float32)

    # diag dominated by the +4/psistot smoothness terms, like the real system
    a1, a4, a2 = f(4.5, 9.0), f(4.5, 9.0), f(-0.4, 0.4)
    if quad:
        offd = [np.full((h, w), -1.0, np.float32)] * 4
    else:
        offd = [-f(0.2, 1.2) for _ in range(4)]
    return dict(zip(FIELDS, [a1, a2, a4, *offd, f(-1, 1), f(-1, 1)]))


def _system(A, quad):
    """The StencilSystem of oracle fields; quad systems carry the scalar -1
    off-diagonals that assemble emits for the quadratic GNC step."""
    fields = [jnp.asarray(A[k]) for k in FIELDS]
    if quad:
        fields[3:7] = [jnp.float32(-1.0)] * 4
    return StencilSystem(*fields)


def _assert_close(got, want, rel=2e-5):
    got = np.asarray(got)
    scale = max(np.abs(want).max(), 1e-3)
    d = np.abs(got - want).max() / scale
    assert d < rel, f"rel diff {d:.3e} exceeds {rel:.0e}"


def _resid(sysm, du, dv):
    au, av = apply_stencil(sysm, du, dv)
    return float(jnp.sum((sysm.bu - au) ** 2) + jnp.sum((sysm.bv - av) ** 2))


class TestSorSolve:
    @pytest.mark.parametrize("shape", [(12, 16), (13, 17), (20, 30)])
    @pytest.mark.parametrize("quad", [True, False])
    def test_matches_oracle(self, shape, quad):
        A = _make_sys(*shape, quad)
        du, dv = sor_solve(_system(A, quad), 1e-8, 8)
        wu, wv, _ = ref.sor_redblack(A, 1e-8, 8)
        _assert_close(du, wu)
        _assert_close(dv, wv)

    @pytest.mark.parametrize("iters", [1, 2, 3, 5, 13, 30])
    def test_sweep_counts(self, iters):
        """Every iteration count runs exactly that many red+black sweeps
        (30 is the default cgiters)."""
        A = _make_sys(15, 26, False, seed=1)
        du, dv = sor_solve(_system(A, False), 1e-8, iters)
        wu, wv, k = ref.sor_redblack(A, 1e-8, iters)
        assert k == iters
        _assert_close(du, wu)
        _assert_close(dv, wv)

    def test_omega_threads_through(self):
        A = _make_sys(12, 16, False, seed=2)
        sysm = _system(A, False)
        du15, _ = sor_solve(sysm, 1e-8, 6, omega=1.5)
        wu15, _, _ = ref.sor_redblack(A, 1e-8, 6, omega=1.5)
        _assert_close(du15, wu15)
        du19, _ = sor_solve(sysm, 1e-8, 6, omega=1.9)
        assert float(jnp.abs(du15 - du19).max()) > 1e-4

    def test_full_grid_stopping_residual(self):
        """The stopping test reads the FULL-GRID ||b - A x||^2, not the
        residual of the red pixels alone: at a tolerance that the red half
        of the residual already meets, the solve keeps going."""
        A = _make_sys(16, 20, False, seed=4)
        sysm = _system(A, False)
        # a tol between the red half and the whole of the residual of the
        # iterate after 3 iterations (omega != 1 leaves a black residual)
        x3u, x3v, _ = ref.sor_redblack(A, 0.0, 3, omega=1.5)
        au, av = ref.apply_stencil_np(A, x3u, x3v)
        r2 = (A["bu"] - au) ** 2 + (A["bv"] - av) ** 2
        red = (np.add.outer(np.arange(16), np.arange(20)) % 2) == 0
        tol = 0.5 * (float(r2.sum()) + float(r2[red].sum()))
        assert r2[red].sum() < tol < r2.sum()
        du, dv = sor_solve(sysm, tol, 50, omega=1.5)
        wu, wv, k = ref.sor_redblack(A, tol, 50, omega=1.5)
        assert 4 < k < 50
        _assert_close(du, wu)
        _assert_close(dv, wv)

    def test_tol_stops_converged_system(self):
        """When the tolerance binds, the solve stops at the oracle's
        iteration, well below the cap, and meets the residual bound.
        (omega=1 -- plain Gauss-Seidel -- because the random test system is
        not SPD, unlike the real Euler-Lagrange system, so over-relaxation
        has no convergence guarantee here.)"""
        A = _make_sys(16, 24, False, seed=3)
        sysm = _system(A, False)
        tol = 1e-3
        du, dv = sor_solve(sysm, tol, 259, omega=1.0)
        wu, wv, k = ref.sor_redblack(A, tol, 259, omega=1.0)
        assert k < 259
        _assert_close(du, wu)
        _assert_close(dv, wv)
        assert _resid(sysm, du, dv) <= tol

    def test_padded_identity_rows(self):
        """With trailing mesh-divisibility padding (``true_hw``) the padded
        pixels are decoupled identity equations: their solution stays
        exactly zero and the true pixels solve the unpadded system."""
        h, w, hp, wp = 13, 17, 16, 24
        A = _make_sys(h, w, False, seed=5)
        padded = {k: np.pad(a, ((0, hp - h), (0, wp - w)), mode="edge")
                  for k, a in A.items()}
        sysm = _mask_padded(_system(padded, False), h, w, hp, wp)
        du, dv = sor_solve(sysm, 1e-8, 8, true_hw=(h, w))
        wu, wv, _ = ref.sor_redblack(A, 1e-8, 8)
        _assert_close(np.asarray(du)[:h, :w], wu)
        _assert_close(np.asarray(dv)[:h, :w], wv)
        for x in (du, dv):
            x = np.asarray(x)
            assert not x[h:].any() and not x[:, w:].any()
