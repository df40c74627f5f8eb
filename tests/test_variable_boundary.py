"""Variable-boundary medium + density-gradient shading normals
(reference: Medium.h:55-107 HeterogeneousMediumWithVariableBoundary +
Gradient.h — present in reference source, never instantiated by its
factory; SURVEY §2.4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cudavolumerenderer_tpu.models import integrator, naive
from cudavolumerenderer_tpu.ops import aabb, gradient
from cudavolumerenderer_tpu.ops.camera import make_camera
from cudavolumerenderer_tpu.ops.grid import Grid
from cudavolumerenderer_tpu.ops.rng import make_rng
from cudavolumerenderer_tpu.scene.types import (
    RenderSettings,
    make_medium,
    make_scene,
)


def _slab_scene(threshold_axis="x"):
    """Hard density edge at x=0.5 of the unit volume: zero density for
    x<0.5, 1.0 for x>=0.5 — an isosurface the march must find."""
    n = 32
    d = np.zeros((n, n, n), np.float32)
    half = n // 2
    if threshold_axis == "x":
        d[:, :, half:] = 1.0
    albedo = np.full((n, n, n, 3), 0.9, np.float32)
    return make_scene(
        make_medium(d, albedo, scale=5.0, max_density=1.0)
    )


class TestGradient:
    def test_central_diff_matches_numpy(self):
        rng = np.random.RandomState(0)
        data = rng.rand(16, 16, 16).astype(np.float32)
        grid = Grid(data=jnp.asarray(data))
        p = jnp.asarray([[0.5, 0.4, 0.6], [0.3, 0.3, 0.3]], jnp.float32)
        g = np.asarray(gradient.gradient_cd(grid, p, 0.05))
        # independent evaluation through the same sampler
        for i, pt in enumerate(np.asarray(p)):
            for ax in range(3):
                dlt = np.zeros(3, np.float32)
                dlt[ax] = 0.05
                hi = float(gradient.volume_intensity(
                    grid, jnp.asarray(pt + dlt)))
                lo = float(gradient.volume_intensity(
                    grid, jnp.asarray(pt - dlt)))
                np.testing.assert_allclose(
                    g[i, ax], lo - hi, rtol=1e-6, atol=1e-7
                )

    def test_outside_is_zero(self):
        grid = Grid(data=jnp.ones((8, 8, 8), jnp.float32))
        p = jnp.asarray([1.2, 0.5, 0.5], jnp.float32)
        assert float(gradient.volume_intensity(grid, p)) == 0.0

    def test_sign_convention_negative_gradient(self):
        """gradient_cd returns MINUS d rho: for density increasing in
        +x, the x component is negative (points toward sparse)."""
        n = 16
        data = np.tile(
            np.linspace(0, 1, n, dtype=np.float32), (n, n, 1)
        )
        grid = Grid(data=jnp.asarray(data))
        g = np.asarray(gradient.gradient_cd(
            grid, jnp.asarray([0.5, 0.5, 0.5], jnp.float32), 0.1
        ))
        assert g[0] < 0.0
        np.testing.assert_allclose(g[1:], 0.0, atol=1e-6)


class TestVariableBoundary:
    def test_march_finds_slab_edge(self):
        """Rays entering along +x must report the boundary near the
        density edge (x=0 world for the half-filled volume), not the
        AABB face at x=-0.5, within the stochastic march resolution."""
        scene = _slab_scene()
        settings = RenderSettings.from_flags(
            True, boundary="variable", boundary_threshold=1e-4,
            russian_roulette=False,
        )
        n = 64
        o = jnp.tile(jnp.asarray([[-2.0, 0.0, 0.0]], jnp.float32),
                     (n, 1))
        d = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32),
                     (n, 1))
        rng = make_rng(7, jnp.arange(n))
        med = scene.medium
        isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
        np.testing.assert_allclose(np.asarray(isect.dist), 1.5,
                                   atol=1e-5)
        isect2, _ = integrator.variable_boundary_adjust(
            scene, settings, o, d, isect, rng,
            jnp.ones((n,), bool),
        )
        dist = np.asarray(isect2.dist)
        hit = np.asarray(isect2.hit)
        assert hit.all()
        # edge at world x ~ 0 (center): ray from -2 → dist ~ 2.0.  The
        # gradient probe spans min_step=0.1 in volume coords (0.1 world
        # here), so the march stops within ~2 probe radii of the edge.
        assert (dist > 1.6).all(), dist.min()
        assert (np.abs(dist - 2.0) < 0.3).all(), (dist.min(), dist.max())
        # shading normal points back toward the sparse side (-x)
        nrm = np.asarray(isect2.normal)
        moved = dist > 1.6
        assert (nrm[moved, 0] < -0.9).all()

    def test_no_surface_means_no_hit(self):
        """A constant-zero density has no gradient anywhere: the march
        crosses the whole box and the lane reports a miss (reference
        return-false branch)."""
        n = 16
        d = np.zeros((n, n, n), np.float32)
        scene = make_scene(make_medium(d, (0.9, 0.9, 0.9), scale=5.0,
                                       max_density=1.0))
        settings = RenderSettings.from_flags(
            True, boundary="variable", boundary_threshold=1e-4,
        )
        m = 8
        o = jnp.tile(jnp.asarray([[-2.0, 0.0, 0.0]], jnp.float32),
                     (m, 1))
        dd = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32),
                      (m, 1))
        rng = make_rng(3, jnp.arange(m))
        med = scene.medium
        isect = aabb.aabb_intersect(med.box_min, med.box_max, o, dd)
        isect2, _ = integrator.variable_boundary_adjust(
            scene, settings, o, dd, isect, rng, jnp.ones((m,), bool)
        )
        assert not np.asarray(isect2.hit).any()
        # inside_volume flips on the no-hit branch (Medium.h:94-96)
        assert np.asarray(isect2.inside_volume).all()

    def test_render_runs_and_differs_from_aabb(self):
        """End-to-end through the naive scheduler: the variable
        boundary must produce a valid image different from the AABB
        boundary on a scene with an interior isosurface."""
        scene = _slab_scene()
        cam = make_camera(16, 16, 35.0, position=(0.0, 0.0, 3.0))
        imgs = {}
        for boundary in ("aabb", "variable"):
            settings = RenderSettings.from_flags(
                True, boundary=boundary, boundary_threshold=1e-4,
                max_path_length=16,
            )
            img, n_rays = naive.render_tile(
                scene, cam, settings, (16, 16),
                jnp.zeros(2, jnp.float32), (16, 16), 2, 11, 0,
            )
            img = np.asarray(img)
            assert np.isfinite(img).all()
            assert float(n_rays) > 0
            imgs[boundary] = img
        assert not np.array_equal(imgs["aabb"], imgs["variable"])

    def test_white_furnace_conserves_with_null_bsdf(self):
        """Energy oracle: albedo 1 + null boundary BSDF keeps every
        pixel at exactly 1.0 regardless of the boundary model — the
        variable boundary moves events but must not create or destroy
        energy."""
        n = 16
        d = np.zeros((n, n, n), np.float32)
        d[:, :, n // 2:] = 1.0
        scene = make_scene(make_medium(d, 1.0, scale=3.0,
                                       max_density=1.0))
        settings = RenderSettings.from_flags(
            True, boundary="variable", boundary_threshold=1e-4,
            bsdf_kind="null", russian_roulette=False,
            max_path_length=200,
        )
        cam = make_camera(8, 8, 35.0, position=(0.0, 0.0, 3.0))
        img, _ = naive.render_tile(
            scene, cam, settings, (8, 8), jnp.zeros(2, jnp.float32),
            (8, 8), 4, 5, 0,
        )
        np.testing.assert_allclose(np.asarray(img) / 4, 1.0, rtol=0,
                                   atol=1e-5)

    def test_factory_rejects_fast_kernels(self):
        from cudavolumerenderer_tpu.config import Config, Kernel
        from cudavolumerenderer_tpu.models.renderer import make_kernel_fn

        cfg = Config(
            kernel=Kernel.FAST_SK,
            settings=RenderSettings.from_flags(True, boundary="variable"),
        )
        with pytest.raises(ValueError, match="integrator-family"):
            make_kernel_fn(cfg)
