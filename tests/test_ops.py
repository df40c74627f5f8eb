"""Unit tests for the core ops: AABB, camera, RNG, grid sampling, HG, GGX,
Woodcock tracking.  Oracles are analytic (closed-form transmittance,
HG moments, Fresnel limits) per SURVEY.md §4's recommended strategy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudavolumerenderer_tpu.constants import EPSILON
from cudavolumerenderer_tpu.ops import aabb, camera, ggx, grid, math3, phase, rng, woodcock


def unit_box():
    return jnp.asarray([-0.5, -0.5, -0.5]), jnp.asarray([0.5, 0.5, 0.5])


class TestRng:
    def test_uniform_range_and_mean(self):
        r = rng.make_rng(1, jnp.arange(10000))
        u, r = rng.next_float(r)
        u = np.asarray(u)
        assert u.min() >= 0.0 and u.max() < 1.0
        assert abs(u.mean() - 0.5) < 0.01
        assert abs(u.std() - np.sqrt(1 / 12)) < 0.01

    def test_streams_independent(self):
        r = rng.make_rng(1, jnp.arange(1000))
        u1, r = rng.next_float(r)
        u2, r = rng.next_float(r)
        corr = np.corrcoef(np.asarray(u1), np.asarray(u2))[0, 1]
        assert abs(corr) < 0.1

    def test_masked_draw_preserves_state(self):
        r = rng.make_rng(1, jnp.arange(8))
        mask = jnp.arange(8) % 2 == 0
        u, r2 = rng.next_float(r, active=mask)
        assert np.all(np.asarray(r2.state)[1::2] == np.asarray(r.state)[1::2])
        assert np.all(np.asarray(r2.state)[0::2] != np.asarray(r.state)[0::2])

    def test_deterministic(self):
        a = rng.make_rng(42, jnp.arange(16))
        b = rng.make_rng(42, jnp.arange(16))
        ua, _ = rng.next_float(a)
        ub, _ = rng.next_float(b)
        np.testing.assert_array_equal(np.asarray(ua), np.asarray(ub))


class TestAABB:
    def test_outside_hit(self):
        bmin, bmax = unit_box()
        o = jnp.asarray([[0.0, 0.0, 2.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        res = aabb.aabb_intersect(bmin, bmax, o, d)
        assert bool(res.hit[0])
        assert not bool(res.inside_volume[0])
        np.testing.assert_allclose(float(res.dist[0]), 1.5, rtol=1e-6)
        # entering through the +z face → reference picks ttop.z normal (+z)
        np.testing.assert_allclose(np.asarray(res.normal[0]), [0, 0, 1], atol=1e-6)

    def test_inside_hit(self):
        bmin, bmax = unit_box()
        o = jnp.asarray([[0.0, 0.0, 0.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        res = aabb.aabb_intersect(bmin, bmax, o, d)
        assert bool(res.hit[0])
        assert bool(res.inside_volume[0])
        np.testing.assert_allclose(float(res.dist[0]), 0.5, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(res.normal[0]), [0, 0, -1], atol=1e-6)

    def test_miss(self):
        bmin, bmax = unit_box()
        o = jnp.asarray([[2.0, 0.0, 2.0]])
        d = jnp.asarray([[0.0, 0.0, -1.0]])
        res = aabb.aabb_intersect(bmin, bmax, o, d)
        assert not bool(res.hit[0])

    def test_pointing_away(self):
        bmin, bmax = unit_box()
        o = jnp.asarray([[0.0, 0.0, 2.0]])
        d = jnp.asarray([[0.0, 0.0, 1.0]])
        res = aabb.aabb_intersect(bmin, bmax, o, d)
        assert not bool(res.hit[0])

    def test_transform(self):
        bmin, bmax = unit_box()
        p01 = aabb.aabb_transform(bmin, bmax, jnp.asarray([0.0, 0.5, -0.5]))
        np.testing.assert_allclose(np.asarray(p01), [0.5, 1.0, 0.0], atol=1e-6)


class TestCamera:
    def test_center_ray_points_down_minus_z(self):
        c = camera.make_camera(64, 64)
        r = rng.make_rng(0, jnp.arange(1))
        # pixel at image center
        o, d, _ = camera.generate_rays(
            c, jnp.asarray([[31.5, 31.5]]), (64, 64), r
        )
        np.testing.assert_allclose(np.asarray(o[0]), [0, 0, 100], atol=1e-6)
        d = np.asarray(d[0])
        assert d[2] < -0.999  # looking down -z
        assert abs(d[0]) < 0.01 and abs(d[1]) < 0.01

    def test_image_y_down_maps_to_world_y_up(self):
        c = camera.make_camera(64, 64)
        r = rng.make_rng(0, jnp.arange(2))
        o, d, _ = camera.generate_rays(
            c, jnp.asarray([[31.5, 0.0], [31.5, 63.0]]), (64, 64), r
        )
        d = np.asarray(d)
        # top image row (y=0) → negative raster y → world +y (up):
        assert d[0][1] > 0 and d[1][1] < 0

    def test_fov_scale(self):
        c = camera.make_camera(64, 64, fov_x_deg=90.0)
        np.testing.assert_allclose(
            float(c.raster_to_view[0]), 1.0, rtol=1e-6
        )  # tan(45°)

    def test_look_at_default_pose_matches_make_camera(self):
        # regression: look_at used to store -forward/+up columns, so
        # orbit/multi-view cameras shot away from the volume
        a = camera.make_camera(64, 64, 0.7)
        b = camera.make_camera_look_at(
            (0.0, 0.0, 100.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 64, 64, 0.7
        )
        np.testing.assert_allclose(
            np.asarray(a.inv_view), np.asarray(b.inv_view), atol=1e-6
        )

    def test_resolution_override_preserves_pose(self):
        """The loader's resolution override must keep a posed look-at
        camera's orientation and only re-derive the fov aspect
        (the old path rebuilt the camera from
        position alone, silently dropping orientation)."""
        from cudavolumerenderer_tpu.scene.loader import override_resolution

        eye = (60.0, 30.0, 50.0)
        c = camera.make_camera_look_at(
            eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 400, 400, 35.0
        )
        c2 = override_resolution(c, 800, 600)
        # pose untouched (orientation AND position)
        np.testing.assert_array_equal(
            np.asarray(c.inv_view), np.asarray(c2.inv_view)
        )
        # fov_x preserved, fov_y re-derived from the new aspect
        np.testing.assert_allclose(
            float(c2.raster_to_view[0]),
            float(c.raster_to_view[0]), rtol=1e-6,
        )
        import math
        fov_x = math.degrees(
            2 * math.atan(float(c.raster_to_view[0]))
        )
        expect_y = math.tan((600 / 800) * fov_x * math.pi / 360.0)
        np.testing.assert_allclose(
            float(c2.raster_to_view[1]), expect_y, rtol=1e-6
        )

    def test_look_at_center_ray_hits_target(self):
        eye = (60.0, 30.0, 50.0)
        c = camera.make_camera_look_at(
            eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 64, 64, 0.7
        )
        r = rng.make_rng(0, jnp.arange(1))
        o, d, _ = camera.generate_rays(
            c, jnp.asarray([[31.5, 31.5]]), (64, 64), r
        )
        to_target = -np.asarray(eye) / np.linalg.norm(eye)
        assert float(np.dot(np.asarray(d[0]), to_target)) > 0.999

    def test_directions_match_float64_at_narrow_fov(self):
        _check_directions_float64(jax.devices("cpu")[0])


def _check_directions_float64(device):
    """At fov 0.7 deg neighbouring pixel directions differ by ~1e-4
    rad, so the view-to-world rotation must keep full f32 (a TF32
    contraction keeps ~3 digits): compare rays generated on `device`
    with a float64 NumPy rotation of the same jittered raster points."""
    res = 512
    c = camera.make_camera_look_at(
        (60.0, 30.0, 50.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
        res, res, 0.7,
    )
    pix = np.stack(np.meshgrid(
        np.arange(0, res, 37.0), np.arange(0, res, 41.0)
    ), -1).reshape(-1, 2).astype(np.float32)
    r = rng.make_rng(3, jnp.arange(len(pix)))
    gen = jax.jit(
        lambda c, p, r: camera.generate_rays(c, p, (res, res), r)[1]
    )
    d = gen(*jax.device_put((c, jnp.asarray(pix), r), device))
    u1, u2, _ = rng.next_float2(r)
    jitter = np.stack([np.asarray(u1), np.asarray(u2)], -1)
    raster = ((pix + jitter) * 2.0 / res - 1.0).astype(np.float64)
    raster *= np.asarray(c.raster_to_view, np.float64)
    d_view = np.concatenate([raster, np.ones((len(pix), 1))], -1)
    d_view /= np.linalg.norm(d_view, axis=-1, keepdims=True)
    rot = np.asarray(c.inv_view, np.float64)[:, :3]
    np.testing.assert_allclose(
        np.asarray(d), d_view @ rot.T, rtol=0, atol=1e-6
    )


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    import (README, "Tests")."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX")


@pytest.mark.gpu
def test_camera_directions_full_precision_on_gpu(gpu_device):
    _check_directions_float64(gpu_device)


class TestGrid:
    def test_trilinear_matches_numpy(self):
        rs = np.random.RandomState(0)
        data = rs.rand(4, 5, 6).astype(np.float32)  # (Z, Y, X)
        g = grid.Grid(data=jnp.asarray(data))
        # at exact voxel coordinates the interpolation returns the voxel
        p01 = jnp.asarray([[2.0 / 5.0, 3.0 / 4.0, 1.0 / 3.0]])  # x,y,z norm
        v = grid.sample_trilinear(g, p01)
        np.testing.assert_allclose(float(v[0]), data[1, 3, 2], rtol=1e-5)

    def test_trilinear_midpoint(self):
        data = np.zeros((1, 1, 2), np.float32)
        data[0, 0, 1] = 1.0
        g = grid.Grid(data=jnp.asarray(data))
        v = grid.sample_trilinear(g, jnp.asarray([[0.5, 0.0, 0.0]]))
        np.testing.assert_allclose(float(v[0]), 0.5, rtol=1e-6)

    def test_clamping(self):
        data = np.arange(8, dtype=np.float32).reshape(2, 2, 2)
        g = grid.Grid(data=jnp.asarray(data))
        v = grid.sample_trilinear(g, jnp.asarray([[1.5, 1.5, 1.5]]))
        np.testing.assert_allclose(float(v[0]), 7.0, rtol=1e-6)

    def test_vector_grid(self):
        data = np.random.RandomState(1).rand(3, 3, 3, 4).astype(np.float32)
        g = grid.Grid(data=jnp.asarray(data))
        v = grid.sample_trilinear(g, jnp.asarray([[0.0, 0.0, 0.0]]))
        np.testing.assert_allclose(np.asarray(v[0]), data[0, 0, 0], rtol=1e-5)

    def test_nearest_truncation(self):
        data = np.arange(27, dtype=np.float32).reshape(3, 3, 3)
        g = grid.Grid(data=jnp.asarray(data))
        v = grid.sample_nearest(g, jnp.asarray([[0.9, 0.0, 0.0]]))
        # coord = 0.9*2 = 1.8 → int() → 1
        np.testing.assert_allclose(float(v[0]), 1.0, rtol=1e-6)


class TestPhase:
    def test_isotropic_uniform(self):
        n = 20000
        r = rng.make_rng(3, jnp.arange(n))
        d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
        out, _ = phase.sample_phase(d, 0.0, r)
        out = np.asarray(out)
        np.testing.assert_allclose(
            np.linalg.norm(out, axis=-1), 1.0, atol=1e-5
        )
        assert np.all(np.abs(out.mean(axis=0)) < 0.02)

    @pytest.mark.parametrize("g", [0.3, -0.5, 0.85])
    def test_mean_cosine_is_g(self, g):
        n = 40000
        r = rng.make_rng(4, jnp.arange(n))
        d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
        out, _ = phase.sample_phase(d, g, r)
        mean_cos = float(np.asarray(out)[:, 2].mean())
        assert abs(mean_cos - g) < 0.02

    def test_pdf_normalized(self):
        # integrate pdf over sphere with midpoint rule in cos-theta
        ct = jnp.linspace(-0.9999, 0.9999, 20001)
        vals = phase.phase_hg(ct, 0.7)
        integral = float(jnp.trapezoid(vals, ct) * 2 * np.pi)
        assert abs(integral - 1.0) < 1e-3


class TestGGX:
    def test_fresnel_eta_one(self):
        f, ndotwt = ggx.fresnel_dielectric(1.0, jnp.asarray([0.7]))
        assert float(f[0]) == 0.0
        np.testing.assert_allclose(float(ndotwt[0]), -0.7, rtol=1e-6)

    def test_fresnel_normal_incidence(self):
        eta = 1.5
        f, _ = ggx.fresnel_dielectric(eta, jnp.asarray([1.0]))
        expected = ((1 - eta) / (1 + eta)) ** 2
        np.testing.assert_allclose(float(f[0]), expected, rtol=1e-5)

    def test_fresnel_tir(self):
        # from dense side at grazing angle: total internal reflection
        f, ndotwt = ggx.fresnel_dielectric(1.5, jnp.asarray([-0.1]))
        assert float(f[0]) == 1.0
        assert float(ndotwt[0]) == 0.0

    @pytest.mark.parametrize("variant", [True, False])
    def test_vndf_upper_hemisphere(self, variant):
        n = 4096
        r = rng.make_rng(5, jnp.arange(n))
        wi = jnp.broadcast_to(
            math3.normalize(jnp.asarray([0.3, -0.2, 0.9])), (n, 3)
        )
        wo, weight, valid, _ = ggx.ggx_sample(
            jnp.asarray([0.1, 0.1]), 1.05 / 1.01, wi, r,
            mitsuba_comparable=variant,
        )
        wo = np.asarray(wo)
        np.testing.assert_allclose(
            np.linalg.norm(wo, axis=-1), 1.0, atol=1e-3
        )
        w = np.asarray(weight)
        assert np.all(w >= 0.0) and np.all(w <= 1.0 + 1e-5)
        assert np.asarray(valid).mean() > 0.95

    def test_smooth_surface_is_near_specular(self):
        n = 2048
        r = rng.make_rng(6, jnp.arange(n))
        wi = jnp.broadcast_to(
            math3.normalize(jnp.asarray([0.5, 0.0, 0.866])), (n, 3)
        )
        wo, weight, valid, _ = ggx.ggx_sample(
            jnp.asarray([0.001, 0.001]), 1.5, wi, r
        )
        wo = np.asarray(wo)
        v = np.asarray(valid)
        refl = wo[:, 2] > 0
        mirror = np.array([-0.5, 0.0, 0.866])
        reflected = wo[v & refl]
        if len(reflected):
            # f32 + the analytic VNDF fit leave a little spread even at
            # alpha=0.001; near-specular means within a few centiradians
            assert np.abs(reflected - mirror).max() < 0.05
            assert np.median(np.abs(reflected - mirror)) < 0.01

    def test_energy_reciprocal_reflection_fraction(self):
        # For eta≈1 almost everything refracts
        n = 8192
        r = rng.make_rng(7, jnp.arange(n))
        wi = jnp.broadcast_to(
            math3.normalize(jnp.asarray([0.0, 0.0, 1.0])), (n, 3)
        )
        wo, _, valid, _ = ggx.ggx_sample(
            jnp.asarray([0.1, 0.1]), 1.0001, wi, r
        )
        frac_reflected = float((np.asarray(wo)[:, 2] > 0).mean())
        assert frac_reflected < 0.01


class TestWoodcock:
    def _homogeneous(self, rho=0.6):
        data = np.full((8, 8, 8), rho, np.float32)
        return grid.Grid(data=jnp.asarray(data))

    def test_transmittance_homogeneous(self):
        """P(no scatter before L) must equal exp(-sigma_t L)."""
        rho, scale, L = 0.6, 5.0, 0.8
        g = self._homogeneous(rho)
        bmin, bmax = unit_box()
        n = 40000
        r = rng.make_rng(8, jnp.arange(n))
        o = jnp.broadcast_to(jnp.asarray([-0.4, 0.0, 0.0]), (n, 3))
        d = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3))
        res = woodcock.woodcock_track(
            g, bmin, bmax, scale, 1.0, o, d,
            jnp.full((n,), L), r, jnp.ones((n,), bool),
        )
        p_scatter = float(np.asarray(res.scattered).mean())
        expected = 1.0 - np.exp(-scale * rho * L)
        assert abs(p_scatter - expected) < 0.01

    def test_distance_distribution_exponential(self):
        rho, scale = 1.0, 10.0
        g = self._homogeneous(rho)
        bmin, bmax = unit_box()
        n = 40000
        r = rng.make_rng(9, jnp.arange(n))
        o = jnp.broadcast_to(jnp.asarray([-0.45, 0.0, 0.0]), (n, 3))
        d = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3))
        res = woodcock.woodcock_track(
            g, bmin, bmax, scale, 1.0, o, d,
            jnp.full((n,), 1e9), r, jnp.ones((n,), bool),
        )
        t = np.asarray(res.t)
        assert abs(t.mean() - 1.0 / (scale * rho)) < 0.005

    def test_inactive_lanes_untouched(self):
        g = self._homogeneous()
        bmin, bmax = unit_box()
        r = rng.make_rng(10, jnp.arange(4))
        o = jnp.zeros((4, 3))
        d = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (4, 3))
        active = jnp.asarray([True, False, True, False])
        res = woodcock.woodcock_track(
            g, bmin, bmax, 5.0, 1.0, o, d, jnp.full((4,), 0.5), r, active
        )
        t = np.asarray(res.t)
        assert t[1] == 0.0 and t[3] == 0.0
        assert not bool(res.scattered[1])
        np.testing.assert_array_equal(
            np.asarray(res.rng.state)[[1, 3]], np.asarray(r.state)[[1, 3]]
        )

    def test_max_density_bound_irrelevant(self):
        """Woodcock is unbiased for any valid majorant: doubling the
        majorant must not change the scatter probability."""
        rho, scale, L = 0.5, 4.0, 0.9
        g = self._homogeneous(rho)
        bmin, bmax = unit_box()
        n = 60000
        ps = []
        for maj, seed in ((0.5, 11), (1.0, 12)):
            r = rng.make_rng(seed, jnp.arange(n))
            o = jnp.broadcast_to(jnp.asarray([-0.45, 0.0, 0.0]), (n, 3))
            d = jnp.broadcast_to(jnp.asarray([1.0, 0.0, 0.0]), (n, 3))
            res = woodcock.woodcock_track(
                g, bmin, bmax, scale, maj, o, d,
                jnp.full((n,), L), r, jnp.ones((n,), bool),
            )
            ps.append(float(np.asarray(res.scattered).mean()))
        assert abs(ps[0] - ps[1]) < 0.01


class TestFrame:
    def test_orthonormal(self):
        n = math3.normalize(jnp.asarray([[0.3, -0.7, 0.2], [1.0, 0.0, 0.0]]))
        x, y, z = math3.frame_from_z(n)
        for v in (x, y, z):
            np.testing.assert_allclose(
                np.asarray(math3.norm(v)), 1.0, atol=1e-6
            )
        np.testing.assert_allclose(np.asarray(math3.dot(x, y)), 0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(math3.dot(x, z)), 0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(math3.dot(y, z)), 0, atol=1e-6)

    def test_roundtrip(self):
        z = math3.normalize(jnp.asarray([[0.1, 0.9, -0.4]]))
        x, y, zn = math3.frame_from_z(z)
        v = math3.normalize(jnp.asarray([[0.5, -0.5, 0.7]]))
        local = math3.to_local(x, y, zn, v)
        back = math3.to_world(x, y, zn, local)
        np.testing.assert_allclose(np.asarray(back), np.asarray(v), atol=1e-6)


def test_loader_applies_non_comparable_handedness(tmp_path):
    """load_scene under mitsuba_comparable=False must negate the
    camera's right basis (reference Camera.h:30-34) — the round-5
    pose-preserving override initially dropped this flip."""
    import numpy as np

    from cudavolumerenderer_tpu.config import Config
    from cudavolumerenderer_tpu.ops.camera import make_camera
    from cudavolumerenderer_tpu.scene import procedural
    from cudavolumerenderer_tpu.scene.loader import load_scene
    from cudavolumerenderer_tpu.scene.types import RenderSettings

    path = str(tmp_path / "blob.raw")
    procedural.write_raw_uchar(path, procedural.blob_volume())

    for comparable in (True, False):
        cfg = Config(
            scene_file=path, resolution=(64, 64),
            settings=RenderSettings.from_flags(comparable),
        )
        _, cam = load_scene(cfg)
        expect = make_camera(64, 64, mitsuba_comparable=comparable)
        np.testing.assert_array_equal(
            np.asarray(cam.inv_view), np.asarray(expect.inv_view)
        )
