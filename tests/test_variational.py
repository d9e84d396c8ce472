"""Parity and property tests for the variational solver."""

import numpy as np
import jax.numpy as jnp
import pytest

from octane_tpu.config import OFConfig
from octane_tpu.flow.stencil import assemble, apply_stencil
from octane_tpu.flow.cg import pcg_solve
from octane_tpu.flow.variational import variational_flow
from octane_tpu.core.gradients import gradient_4th

import reference_impl as ref


def _pair(h=20, w=24, seed=0, shift=1.3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = (
        120.0 * np.exp(-(((xx - w / 2) ** 2 + (yy - h / 2) ** 2) / 18.0))
        + 60.0 * np.sin(xx / 3.0) * np.cos(yy / 2.0)
        + 40.0
    )
    im1 = base + rng.normal(0, 1, (h, w))
    im2 = (
        120.0 * np.exp(-(((xx - w / 2 - shift) ** 2 + (yy - h / 2) ** 2) / 18.0))
        + 60.0 * np.sin((xx - shift) / 3.0) * np.cos(yy / 2.0)
        + 40.0
        + rng.normal(0, 1, (h, w))
    )
    return im1.astype(np.float32), im2.astype(np.float32)


def _oracle_grads(g1, g2):
    grads = {}
    grads["gx1"], grads["gy1"] = (np.stack(a) for a in zip(*[ref.compgrad(c) for c in g1]))
    grads["gx2"], grads["gy2"] = (np.stack(a) for a in zip(*[ref.compgrad(c) for c in g2]))
    grads["gxx"] = np.stack([ref.compgrad(c)[0] for c in grads["gx2"]])
    grads["gxy"] = np.stack([ref.compgrad(c)[0] for c in grads["gy2"]])
    grads["gyy"] = np.stack([ref.compgrad(c)[1] for c in grads["gy2"]])
    return grads


COEFS = ("a1", "a2", "a4", "a5", "a6", "a7", "a8", "bu", "bv")


class TestAssemblyParity:
    # al1_static=1.0: the quadratic GNC step traced with al1 known, which
    # skips the robust block and emits scalar -1 off-diagonals
    @pytest.mark.parametrize("al1,al1_static", [
        pytest.param(1.0, None, id="1.0"),
        pytest.param(1.0, 1.0, id="1.0-static"),
        pytest.param(0.5, None, id="0.5"),
        pytest.param(0.0, None, id="0.0")])
    @pytest.mark.parametrize("dozim", [True, False])
    def test_coefficients_match_oracle(self, al1, al1_static, dozim):
        im1, im2 = _pair()
        h, w = im1.shape
        rng = np.random.default_rng(1)
        u = rng.normal(0, 1.5, (h, w)).astype(np.float32)
        v = rng.normal(0, 1.5, (h, w)).astype(np.float32)
        uhat = rng.normal(0, 0.5, (h, w)).astype(np.float32)
        vhat = rng.normal(0, 0.5, (h, w)).astype(np.float32)
        alpha, lam, lambdac = 5.0, 1.0, 0.3

        g1 = im1[None]
        g2 = im2[None]
        grads = {}
        grads["gx1"], grads["gy1"] = (np.stack(a) for a in zip(*[ref.compgrad(c) for c in g1]))
        grads["gx2"], grads["gy2"] = (np.stack(a) for a in zip(*[ref.compgrad(c) for c in g2]))
        grads["gxx"] = np.stack([ref.compgrad(c)[0] for c in grads["gx2"]])
        grads["gxy"] = np.stack([ref.compgrad(c)[0] for c in grads["gy2"]])
        grads["gyy"] = np.stack([ref.compgrad(c)[1] for c in grads["gy2"]])
        want = ref.assemble(g1, g2, grads, u, v, uhat, vhat,
                            al1, alpha, lam / alpha, lambdac, dozim)

        gx1, gy1 = gradient_4th(jnp.asarray(g1))
        gx2, gy2 = gradient_4th(jnp.asarray(g2))
        gxx, _ = gradient_4th(gx2)
        gxy, gyy = gradient_4th(gy2)
        got = assemble(jnp.asarray(g1), jnp.asarray(g2), gx1, gy1, gx2, gy2,
                       gxx, gxy, gyy, jnp.asarray(u), jnp.asarray(v),
                       jnp.asarray(uhat), jnp.asarray(vhat),
                       al1, alpha, lam / alpha, lambdac, dozim,
                       al1_static=al1_static)
        for name, field in zip(COEFS, got):
            np.testing.assert_allclose(
                np.asarray(field), want[name], rtol=2e-4, atol=2e-4,
                err_msg=f"coefficient {name} (al1={al1}, dozim={dozim})",
            )

    def test_padded_assembly_matches_oracle(self):
        """On an edge-padded (mesh-divisibility) frame with ``true_hw``, the
        true pixels assemble the unpadded system and the padded pixels are
        decoupled identity rows (a1 = a4 = 1, everything else 0)."""
        im1, im2 = _pair()
        h, w = im1.shape
        hp, wp = h + 4, w + 8
        rng = np.random.default_rng(3)
        u = rng.normal(0, 1.5, (h, w)).astype(np.float32)
        v = rng.normal(0, 1.5, (h, w)).astype(np.float32)
        g1, g2 = im1[None], im2[None]
        want = ref.assemble(g1, g2, _oracle_grads(g1, g2), u, v, u * 0, v * 0,
                            0.5, 5.0, 0.2, 0.1, True)

        def pad(a):
            return jnp.asarray(np.pad(a, [(0, 0)] * (a.ndim - 2)
                                      + [(0, hp - h), (0, wp - w)],
                                      mode="edge"))

        thw = (h, w)
        p1, p2 = pad(g1), pad(g2)
        gx1, gy1 = gradient_4th(p1, thw)
        gx2, gy2 = gradient_4th(p2, thw)
        gxx, _ = gradient_4th(gx2, thw)
        gxy, gyy = gradient_4th(gy2, thw)
        z = jnp.zeros((hp, wp), jnp.float32)
        got = assemble(p1, p2, gx1, gy1, gx2, gy2, gxx, gxy, gyy,
                       pad(u), pad(v), z, z, 0.5, 5.0, 0.2, 0.1, True,
                       true_hw=thw)
        for name, field in zip(COEFS, got):
            field = np.asarray(field)
            np.testing.assert_allclose(field[:h, :w], want[name],
                                       rtol=2e-4, atol=2e-4, err_msg=name)
            ident = 1.0 if name in ("a1", "a4") else 0.0
            assert (field[h:] == ident).all() and (field[:, w:] == ident).all()

    def test_gradients_match_oracle(self):
        im1, _ = _pair()
        gx, gy = ref.compgrad(im1)
        jgx, jgy = gradient_4th(jnp.asarray(im1))
        np.testing.assert_allclose(np.asarray(jgx), gx, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(np.asarray(jgy), gy, rtol=1e-5, atol=1e-4)


class TestStencilOperator:
    def test_matches_dense_matrix(self):
        """Matrix-free apply == the CSR fill's dense matrix (incl. edge folding)."""
        im1, im2 = _pair(12, 14)
        h, w = im1.shape
        rng = np.random.default_rng(2)
        u = rng.normal(0, 1, (h, w)).astype(np.float32)
        v = rng.normal(0, 1, (h, w)).astype(np.float32)
        gx1, gy1 = gradient_4th(jnp.asarray(im1[None]))
        gx2, gy2 = gradient_4th(jnp.asarray(im2[None]))
        gxx, _ = gradient_4th(gx2)
        gxy, gyy = gradient_4th(gy2)
        sys = assemble(jnp.asarray(im1[None]), jnp.asarray(im2[None]),
                       gx1, gy1, gx2, gy2, gxx, gxy, gyy,
                       jnp.asarray(u), jnp.asarray(v),
                       jnp.zeros((h, w)), jnp.zeros((h, w)),
                       0.5, 5.0, 0.2, 0.0, True)
        A = {k: np.asarray(getattr(sys, k)) for k in
             ("a1", "a2", "a4", "a5", "a6", "a7", "a8")}
        A["bu"] = np.asarray(sys.bu)
        A["bv"] = np.asarray(sys.bv)
        M = ref.dense_matrix(A)
        du = rng.normal(0, 1, (h, w)).astype(np.float32)
        dv = rng.normal(0, 1, (h, w)).astype(np.float32)
        x = np.empty(2 * h * w, np.float32)
        x[0::2] = du.reshape(-1)
        x[1::2] = dv.reshape(-1)
        want = M @ x
        au, av = apply_stencil(sys, jnp.asarray(du), jnp.asarray(dv))
        got = np.empty_like(want)
        got[0::2] = np.asarray(au).reshape(-1)
        got[1::2] = np.asarray(av).reshape(-1)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


class TestPCG:
    def test_matches_oracle_pcg(self):
        im1, im2 = _pair(12, 14)
        h, w = im1.shape
        gx1, gy1 = gradient_4th(jnp.asarray(im1[None]))
        gx2, gy2 = gradient_4th(jnp.asarray(im2[None]))
        gxx, _ = gradient_4th(gx2)
        gxy, gyy = gradient_4th(gy2)
        z = jnp.zeros((h, w))
        sys = assemble(jnp.asarray(im1[None]), jnp.asarray(im2[None]),
                       gx1, gy1, gx2, gy2, gxx, gxy, gyy,
                       z, z, z, z, 1.0, 5.0, 0.2, 0.0, True)
        A = {k: np.asarray(getattr(sys, k)) for k in
             ("a1", "a2", "a4", "a5", "a6", "a7", "a8", "bu", "bv")}
        M = ref.dense_matrix(A)
        diag = np.empty(2 * h * w, np.float32)
        diag[0::2] = A["a1"].reshape(-1)
        diag[1::2] = A["a4"].reshape(-1)
        b = np.empty(2 * h * w, np.float32)
        b[0::2] = A["bu"].reshape(-1)
        b[1::2] = A["bv"].reshape(-1)
        want = ref.pcg(M, diag, b, 1e-8, 30)
        du, dv = pcg_solve(lambda a, c: apply_stencil(sys, a, c),
                           sys.a1, sys.a4, sys.bu, sys.bv, 1e-8, 30)
        got = np.empty_like(want)
        got[0::2] = np.asarray(du).reshape(-1)
        got[1::2] = np.asarray(dv).reshape(-1)
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)


class TestEndToEnd:
    def test_solve_level_matches_oracle(self):
        """One pyramid level (3 GNC steps x liters relinearizations) with
        first-guess hinting engaged (lambdac > 0, nonzero uhat/vhat)."""
        from octane_tpu.flow.variational import solve_level

        im1, im2 = _pair(16, 18, shift=1.0)
        h, w = im1.shape
        rng = np.random.default_rng(5)
        uhat = rng.normal(1.0, 0.3, (h, w)).astype(np.float32)
        vhat = rng.normal(0.0, 0.3, (h, w)).astype(np.float32)
        alpha, lam, lambdac, tol = 5.0, 1.0, 0.2, 1e-8
        want_u, want_v = ref.solve_level_matfree(
            im1[None], im2[None], uhat.copy(), vhat.copy(), uhat, vhat,
            alpha, lam, lambdac, 2, 10, tol, True)
        got_u, got_v = solve_level(
            jnp.asarray(im1[None]), jnp.asarray(im2[None]),
            jnp.asarray(uhat), jnp.asarray(vhat),
            jnp.asarray(uhat), jnp.asarray(vhat),
            jnp.float32(alpha), jnp.float32(lam / alpha),
            jnp.float32(lambdac), jnp.float32(tol),
            liters=2, cgiters=10, gnc_steps=3, dozim=True)
        np.testing.assert_allclose(np.asarray(got_u), want_u, atol=5e-3)
        np.testing.assert_allclose(np.asarray(got_v), want_v, atol=5e-3)

    def test_full_solve_matches_oracle(self):
        im1, im2 = _pair(18, 22, shift=1.0)
        h, w = im1.shape
        z = np.zeros((h, w), np.float32)
        want_u, want_v = ref.variational_flow(
            im1, im2, z, z, kiters=2, liters=2, cgiters=10)
        cfg = OFConfig(kiters=2, liters=2, cgiters=10)
        got_u, got_v = variational_flow(im1, im2, z, z, cfg)
        np.testing.assert_allclose(np.asarray(got_u), want_u, atol=5e-3)
        np.testing.assert_allclose(np.asarray(got_v), want_v, atol=5e-3)

    def test_identical_images_zero_flow(self):
        im1, _ = _pair(24, 24)
        z = np.zeros_like(im1)
        cfg = OFConfig(kiters=2)
        u, v = variational_flow(im1, im1, z, z, cfg)
        assert np.abs(np.asarray(u)).max() < 1e-3
        assert np.abs(np.asarray(v)).max() < 1e-3

    def test_translation_recovered(self):
        h = w = 64
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        blob = lambda cx: 200 * np.exp(-(((xx - cx) ** 2 + (yy - 32) ** 2) / 128.0)) + 30
        im1, im2 = blob(30), blob(33)
        z = np.zeros((h, w), np.float32)
        cfg = OFConfig(kiters=3)
        u, v = variational_flow(im1, im2, z, z, cfg)
        m = blob(30) > 90
        assert abs(np.asarray(u)[m].mean() - 3.0) < 0.05
        assert abs(np.asarray(v)[m].mean()) < 0.05

    def test_sor_close_to_pcg(self):
        im1, im2 = _pair(32, 32, shift=1.0)
        z = np.zeros_like(im1)
        u1, v1 = variational_flow(im1, im2, z, z, OFConfig(kiters=2))
        u2, v2 = variational_flow(
            im1, im2, z, z, OFConfig(kiters=2, solver="sor", cgiters=120))
        np.testing.assert_allclose(np.asarray(u1), np.asarray(u2), atol=0.08)

    def test_sor_converges_to_pcg_solution(self):
        """Run BOTH solvers to convergence on one system: SOR's iterate
        path differs from PCG's, but the solution is the same (tight)."""
        import jax.numpy as jnp
        from octane_tpu.flow.stencil import StencilSystem, apply_stencil
        from octane_tpu.flow.cg import pcg_solve, sor_solve

        h, w = 40, 48
        rng = np.random.default_rng(2)

        def arr(lo, hi):
            return jnp.asarray(rng.uniform(lo, hi, (h, w)).astype(np.float32))

        s = StencilSystem(arr(4.5, 9.0), arr(-0.2, 0.2), arr(4.5, 9.0),
                          *[-arr(0.3, 1.0) for _ in range(4)],
                          arr(-10, 10), arr(-10, 10))
        tol = jnp.float32(1e-8)
        du, dv = pcg_solve(lambda a, b: apply_stencil(s, a, b),
                           s.a1, s.a4, s.bu, s.bv, tol, 400)
        su, sv = sor_solve(s, tol, 4000)
        scale = float(jnp.abs(du).max())
        d = max(float(jnp.abs(su - du).max()), float(jnp.abs(sv - dv).max()))
        assert d / scale < 1e-4, f"rel diff at convergence {d / scale:.2e}"

    def test_sor_early_stop_on_tol(self):
        """The convergence check must actually fire: a loose tol stops far
        below the iteration cap and still yields a near-solution."""
        import jax.numpy as jnp
        from octane_tpu.flow.stencil import StencilSystem
        from octane_tpu.flow.cg import sor_solve

        h, w = 24, 24
        rng = np.random.default_rng(4)

        def arr(lo, hi):
            return jnp.asarray(rng.uniform(lo, hi, (h, w)).astype(np.float32))

        s = StencilSystem(arr(6.0, 9.0), arr(-0.1, 0.1), arr(6.0, 9.0),
                          *[-arr(0.3, 0.8) for _ in range(4)],
                          arr(-10, 10), arr(-10, 10))
        u_tight, _ = sor_solve(s, jnp.float32(1e-10), 4000)
        u_loose, _ = sor_solve(s, jnp.float32(1.0), 4000)
        # loose tol stopped earlier -> different (but close) iterate
        d = float(jnp.abs(u_tight - u_loose).max())
        assert 0.0 < d < 0.1


class TestMultiChannelAssembly:
    def test_two_channel_coefficients_match_oracle(self):
        im1a, im2a = _pair(16, 18, seed=0)
        im1b, im2b = _pair(16, 18, seed=4)
        g1 = np.stack([im1a, im1b])
        g2 = np.stack([im2a, im2b])
        h, w = im1a.shape
        rng = np.random.default_rng(6)
        u = rng.normal(0, 1.0, (h, w)).astype(np.float32)
        v = rng.normal(0, 1.0, (h, w)).astype(np.float32)
        z = np.zeros((h, w), np.float32)
        grads = {}
        grads["gx1"], grads["gy1"] = (np.stack(a) for a in zip(*[ref.compgrad(c) for c in g1]))
        grads["gx2"], grads["gy2"] = (np.stack(a) for a in zip(*[ref.compgrad(c) for c in g2]))
        grads["gxx"] = np.stack([ref.compgrad(c)[0] for c in grads["gx2"]])
        grads["gxy"] = np.stack([ref.compgrad(c)[0] for c in grads["gy2"]])
        grads["gyy"] = np.stack([ref.compgrad(c)[1] for c in grads["gy2"]])
        want = ref.assemble(g1, g2, grads, u, v, z, z, 0.5, 5.0, 0.2, 0.0, True)

        gx1, gy1 = gradient_4th(jnp.asarray(g1))
        gx2, gy2 = gradient_4th(jnp.asarray(g2))
        gxx, _ = gradient_4th(gx2)
        gxy, gyy = gradient_4th(gy2)
        got = assemble(jnp.asarray(g1), jnp.asarray(g2), gx1, gy1, gx2, gy2,
                       gxx, gxy, gyy, jnp.asarray(u), jnp.asarray(v),
                       jnp.asarray(z), jnp.asarray(z), 0.5, 5.0, 0.2, 0.0, True)
        for name, field in zip(("a1", "a2", "a4", "a5", "a6", "a7", "a8",
                                "bu", "bv"), got):
            np.testing.assert_allclose(np.asarray(field), want[name],
                                       rtol=3e-4, atol=3e-4, err_msg=name)
