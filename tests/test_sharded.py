"""Distributed correctness on a virtual 8-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from octane_tpu.config import OFConfig
from octane_tpu.flow.variational import variational_flow
from octane_tpu.flow.stencil import warp_bilinear_dense
from octane_tpu.parallel.mesh import make_mesh, flow_sharding
from octane_tpu.parallel.halo import halo_pad2d
from octane_tpu.parallel.sharded import make_sharded_warp, sharded_variational_flow

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def _pair(h, w, shift=3.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    mk = lambda cx: 200 * np.exp(-(((xx - cx) ** 2 + (yy - h / 2) ** 2)
                                   / (2 * (w / 10) ** 2))) + 30
    return mk(w / 2 - shift / 2), mk(w / 2 + shift / 2)


class TestHalo:
    def test_halo_pad_matches_pad_edge(self):
        mesh = make_mesh((2, 4))
        rng = np.random.default_rng(0)
        x = rng.normal(0, 1, (16, 32)).astype(np.float32)
        halo = 3

        @jax.jit
        def padded(x):
            from jax.sharding import PartitionSpec as P
            f = jax.shard_map(
                lambda b: halo_pad2d(b, halo),
                mesh=mesh, in_specs=P("dy", "dx"),
                out_specs=P("dy", "dx"))
            return f(x)

        out = np.asarray(padded(jax.device_put(x, flow_sharding(mesh))))
        # reassemble: each shard block is (8+2h, 8+2h); check one interior shard
        hl, wl = 8, 8
        blk = out.reshape(2, hl + 2 * halo, 4, wl + 2 * halo)
        b01 = blk[0, :, 1, :]     # shard (0,1)
        want = np.pad(x, halo, mode="edge")[0:hl + 2 * halo,
                                            wl:2 * wl + 2 * halo]
        np.testing.assert_array_equal(b01, want)


class TestShardedWarp:
    def test_matches_dense_for_small_flow(self):
        """Within reach the halo gather equals the dense gather."""
        self._check_against_dense(edge_bands=False)

    def test_matches_dense_in_edge_bands(self):
        """Samples pushed into the sub-pixel extrapolation bands just inside
        the global right/bottom edges (px in (w-1, w), py in (h-1, h))."""
        self._check_against_dense(edge_bands=True)

    @staticmethod
    def _check_against_dense(edge_bands):
        mesh = make_mesh((2, 4))
        h, w = 32, 64
        rng = np.random.default_rng(1)
        fields = rng.normal(0, 1, (3, h, w)).astype(np.float32)
        u = rng.uniform(-2.5, 2.5, (h, w)).astype(np.float32)
        v = rng.uniform(-2.5, 2.5, (h, w)).astype(np.float32)
        if edge_bands:
            u[:, -1] = 0.7
            v[-1, :] = 0.4
        want, bx, by = warp_bilinear_dense(
            jnp.asarray(fields), jnp.asarray(u), jnp.asarray(v))
        warp = make_sharded_warp(mesh, (h, w), halo=6)
        got, gbx, gby = jax.jit(warp)(
            jax.device_put(jnp.asarray(fields),
                           jax.sharding.NamedSharding(
                               mesh, jax.sharding.PartitionSpec(None, "dy", "dx"))),
            jax.device_put(jnp.asarray(u), flow_sharding(mesh)),
            jax.device_put(jnp.asarray(v), flow_sharding(mesh)))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(gbx), np.asarray(bx))
        np.testing.assert_array_equal(np.asarray(gby), np.asarray(by))


class TestShardedWarpReachGuard:
    def test_falls_back_beyond_reach(self):
        """Flow beyond halo-2 must take the dense-gather branch: results
        match the unbounded sampler exactly (never silently clamped)."""
        mesh = make_mesh((2, 4))
        h, w = 32, 64
        rng = np.random.default_rng(3)
        fields = rng.normal(0, 1, (2, h, w)).astype(np.float32)
        u = rng.uniform(-12, 12, (h, w)).astype(np.float32)   # reach = 4
        v = rng.uniform(-12, 12, (h, w)).astype(np.float32)
        want, bx, by = warp_bilinear_dense(
            jnp.asarray(fields), jnp.asarray(u), jnp.asarray(v))
        warp = make_sharded_warp(mesh, (h, w), halo=6)
        got, gbx, gby = jax.jit(warp)(
            jax.device_put(jnp.asarray(fields),
                           jax.sharding.NamedSharding(
                               mesh, jax.sharding.PartitionSpec(None, "dy", "dx"))),
            jax.device_put(jnp.asarray(u), flow_sharding(mesh)),
            jax.device_put(jnp.asarray(v), flow_sharding(mesh)))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(gbx), np.asarray(bx))


def _system(h, w, quad, seed=1):
    from octane_tpu.flow.stencil import StencilSystem

    rng = np.random.default_rng(seed)

    def arr(lo, hi):
        return jnp.asarray(rng.uniform(lo, hi, (h, w)).astype(np.float32))

    offd = ((jnp.float32(-1),) * 4 if quad
            else tuple(-arr(0.3, 1.0) for _ in range(4)))
    return StencilSystem(arr(4.5, 9.0), arr(-0.2, 0.2), arr(4.5, 9.0),
                         *offd, arr(-100, 100), arr(-100, 100))


def _shard(sysm, mesh):
    fsh = flow_sharding(mesh)
    return type(sysm)(*(jax.device_put(a, fsh) if a.ndim == 2 else a
                        for a in sysm))


class TestShardedSolvers:
    """The solvers as the sharded program runs them: the same jnp code,
    partitioned by GSPMD over the 2x4 mesh (halo collectives for the
    stencil shifts, all-reduces for the dots), against one device."""

    @pytest.mark.parametrize("quad", [True, False])
    def test_pcg_matches_single_device(self, quad):
        from octane_tpu.flow.cg import pcg_solve
        from octane_tpu.flow.stencil import apply_stencil

        mesh = make_mesh((2, 4))
        s = _system(32, 64, quad)

        def solve(s):
            return pcg_solve(lambda a, b: apply_stencil(s, a, b),
                             s.a1, s.a4, s.bu, s.bv, jnp.float32(1e-8), 10)

        du, dv = jax.jit(solve)(s)
        fsh = flow_sharding(mesh)
        fu, fv = jax.jit(solve, out_shardings=(fsh, fsh))(_shard(s, mesh))
        assert fu.sharding == fsh
        scale = float(jnp.abs(du).max())
        d = max(float(jnp.abs(fu - du).max()), float(jnp.abs(fv - dv).max()))
        # the dots' partial sums are reduced in another order
        assert d / scale < 1e-4, f"rel diff {d / scale:.2e} (quad={quad})"

    @pytest.mark.parametrize("quad", [True, False])
    @pytest.mark.parametrize("iters", [8, 13])
    def test_sor_matches_single_device(self, quad, iters):
        from octane_tpu.flow.cg import sor_solve

        mesh = make_mesh((2, 4))
        s = _system(32, 64, quad)

        def solve(s):
            return sor_solve(s, jnp.float32(1e-8), iters)

        du, dv = jax.jit(solve)(s)
        fsh = flow_sharding(mesh)
        fu, fv = jax.jit(solve, out_shardings=(fsh, fsh))(_shard(s, mesh))
        scale = float(jnp.abs(du).max())
        d = max(float(jnp.abs(fu - du).max()), float(jnp.abs(fv - dv).max()))
        assert d / scale < 2e-5, f"rel diff {d / scale:.2e} (quad={quad})"


class TestPaddedSharding:
    @pytest.mark.slow
    def test_odd_dims_match_single_device(self):
        """Non-mesh-divisible dims: the divisibility padding must reproduce
        the unpadded single-device solve at every true pixel."""
        h, w = 54, 50
        im1, im2 = _pair(h, w, shift=2.0)
        z = np.zeros((h, w), np.float32)
        cfg = OFConfig(kiters=2, halo_warp=8, cgiters=10)
        u1, v1 = variational_flow(im1, im2, z, z, cfg)
        mesh = make_mesh((2, 4))
        u2, v2 = sharded_variational_flow(im1, im2, z, z, cfg, mesh)
        assert np.asarray(u2).shape == (h, w)
        np.testing.assert_allclose(np.asarray(u1), np.asarray(u2), atol=1e-3)
        np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-3)

    def test_padded_shape_search(self):
        from octane_tpu.parallel.sharded import padded_global_shape
        cfg = OFConfig(kiters=4)
        got = padded_global_shape((5424, 5424), cfg, (2, 4))
        assert got is not None
        hp, wp = got
        assert hp >= 5424 and wp >= 5424
        from octane_tpu.core.zoom import zoom_size
        for j in range(4):
            f = float(np.float32(0.5) ** j)
            assert zoom_size(hp, f) % 2 == 0
            assert zoom_size(wp, f) % 4 == 0


class TestShardedSolve:
    @pytest.mark.slow
    def test_matches_single_device(self):
        h = w = 64
        im1, im2 = _pair(h, w)
        z = np.zeros((h, w), np.float32)
        cfg = OFConfig(kiters=3, halo_warp=8)
        u1, v1 = variational_flow(im1, im2, z, z, cfg)
        mesh = make_mesh((2, 4))
        u2, v2 = sharded_variational_flow(im1, im2, z, z, cfg, mesh)
        np.testing.assert_allclose(np.asarray(u1), np.asarray(u2), atol=1e-3)
        np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-3)

    @pytest.mark.slow
    def test_1d_mesh(self):
        h = w = 32
        im1, im2 = _pair(h, w, shift=1.5)
        z = np.zeros((h, w), np.float32)
        cfg = OFConfig(kiters=2, halo_warp=4, cgiters=10)
        u1, v1 = variational_flow(im1, im2, z, z, cfg)
        mesh = make_mesh((1, 8))
        u2, v2 = sharded_variational_flow(im1, im2, z, z, cfg, mesh)
        np.testing.assert_allclose(np.asarray(u1), np.asarray(u2), atol=1e-3)


class TestShardedPost:
    """Sharded post-processing vs the single-device programs."""

    def test_pix2uv_matches(self):
        from octane_tpu.io.datamodel import NavConstants
        from octane_tpu.nav.winds import pix2uv
        from octane_tpu.parallel.post import sharded_pix2uv

        mesh = make_mesh((2, 4))
        h, w = 16, 32
        nav = NavConstants(
            grid="goes", x_scale=5.6e-05, x_offset=-0.101332,
            y_scale=-5.6e-05, y_offset=0.128212, min_x=100.0, min_y=200.0)
        nav.g2x_offset = nav.x_offset
        nav.g2y_offset = nav.y_offset
        rng = np.random.default_rng(3)
        u = rng.uniform(-3, 3, (h, w)).astype(np.float32)
        v = rng.uniform(-3, 3, (h, w)).astype(np.float32)
        want = pix2uv(u, v, nav, 60.0)
        got = sharded_pix2uv(u, v, nav, 60.0, mesh)
        for g, wnt in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(wnt))

    @pytest.mark.slow
    def test_srsal_matches(self):
        from octane_tpu.post.srsal import srsal_smooth
        from octane_tpu.parallel.post import sharded_srsal

        mesh = make_mesh((2, 4))
        h, w = 48, 96          # local blocks 24x24 > p=18
        rng = np.random.default_rng(4)
        u = rng.normal(0, 3, (h, w)).astype(np.float32)
        v = rng.normal(0, 3, (h, w)).astype(np.float32)
        cth = rng.normal(8000, 40, (h, w)).astype(np.float32)
        wu, wv = srsal_smooth(u, v, cth)
        gu, gv = sharded_srsal(u, v, cth, mesh)
        np.testing.assert_allclose(np.asarray(gu), np.asarray(wu),
                                   rtol=2e-6, atol=2e-6)
        np.testing.assert_allclose(np.asarray(gv), np.asarray(wv),
                                   rtol=2e-6, atol=2e-6)

    def test_srsal_small_blocks_fall_back(self):
        from octane_tpu.post.srsal import srsal_smooth
        from octane_tpu.parallel.post import sharded_srsal

        mesh = make_mesh((2, 4))
        h, w = 24, 48          # local 12x12 <= p: single-program path
        rng = np.random.default_rng(5)
        u = rng.normal(0, 3, (h, w)).astype(np.float32)
        v = rng.normal(0, 3, (h, w)).astype(np.float32)
        cth = rng.normal(8000, 40, (h, w)).astype(np.float32)
        wu, _ = srsal_smooth(u, v, cth)
        gu, _ = sharded_srsal(u, v, cth, mesh)
        np.testing.assert_array_equal(np.asarray(gu), np.asarray(wu))

    def test_interpolate_frame_matches(self):
        from octane_tpu.post.temporal import interpolate_frame
        from octane_tpu.parallel.post import sharded_interpolate_frame

        mesh = make_mesh((2, 4))
        h, w = 64, 128
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        im1 = (100 * np.exp(-(((xx - 40) ** 2 + (yy - 32) ** 2) / 300.0))
               + 20 * np.sin(xx / 5.0) + 40).astype(np.float32)[None]
        im2 = (100 * np.exp(-(((xx - 44) ** 2 + (yy - 30) ** 2) / 300.0))
               + 20 * np.sin((xx - 4) / 5.0) + 40).astype(np.float32)[None]
        rng = np.random.default_rng(6)
        u = (4.0 + rng.normal(0, 0.3, (h, w))).astype(np.float32)
        v = (-2.0 + rng.normal(0, 0.3, (h, w))).astype(np.float32)
        want_img, want_occ = interpolate_frame(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(im1),
            jnp.asarray(im2), 0.4)
        got_img, got_occ = sharded_interpolate_frame(
            u, v, im1, im2, 0.4, mesh, max_disp=6)
        np.testing.assert_array_equal(np.asarray(got_occ),
                                      np.asarray(want_occ))
        np.testing.assert_allclose(np.asarray(got_img),
                                   np.asarray(want_img), rtol=1e-6, atol=1e-5)

    def test_interpolate_frame_global_edges(self):
        """Phantom splat sources from halo edge-replication must never win:
        strong non-uniform flow AT the global boundary makes filled-hole
        values differ clearly from any phantom splat value."""
        from octane_tpu.post.temporal import interpolate_frame
        from octane_tpu.parallel.post import sharded_interpolate_frame

        mesh = make_mesh((2, 4))
        h, w = 64, 128
        rng = np.random.default_rng(21)
        im1 = rng.normal(100, 30, (1, h, w)).astype(np.float32)
        im2 = np.roll(im1, (0, -2, 5), axis=(0, 1, 2)).astype(np.float32)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        # flow varies strongly along the edges (sin) so a phantom copy of an
        # edge pixel carries a visibly different value than the hole fill
        u = (5.0 + 3.0 * np.sin(yy / 3.0)).astype(np.float32)
        v = (-2.0 + 2.0 * np.cos(xx / 4.0)).astype(np.float32)
        want_img, want_occ = interpolate_frame(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(im1),
            jnp.asarray(im2), 0.5)
        got_img, got_occ = sharded_interpolate_frame(
            u, v, im1, im2, 0.5, mesh, max_disp=9)
        np.testing.assert_array_equal(np.asarray(got_occ),
                                      np.asarray(want_occ))
        np.testing.assert_allclose(np.asarray(got_img),
                                   np.asarray(want_img), rtol=1e-6, atol=1e-5)
