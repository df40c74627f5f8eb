"""Gradient checks for the differentiable renderer (SURVEY.md §4c).

Key facts used:
- With Russian roulette off, path trajectories do not depend on albedo
  at all, so fixed-seed finite differences in albedo are exact and must
  match the reparameterized albedo gradient per-pixel.
- Density gradients use the score-function estimator, which estimates
  the derivative of the *expectation*; we check it against the analytic
  transmittance derivative d/drho exp(-scale*rho*L) in an
  absorption-only configuration (albedo = 0, pass-through boundary).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cudavolumerenderer_tpu.models.differentiable import (
    CameraSpec,
    SceneSpec,
    render_diff,
)
from cudavolumerenderer_tpu.scene.types import RenderSettings


def settings_nr(max_len=16):
    return RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=max_len,
        bsdf_kind="null",
    )


RES = (4, 4)
SPEC = SceneSpec(scale=2.0, max_density=1.0)
# fov narrow enough that every ray crosses the box (the default 0.7°
# over-scans the unit box from z=100: 100*tan(0.35°) ≈ 0.61 > 0.5)
CAM = CameraSpec(res_x=4, res_y=4, fov_x_deg=0.4)


def grids(rho=0.5, alb=0.6, n=4):
    density = jnp.full((n, n, n), rho, jnp.float32)
    albedo = jnp.full((n, n, n, 4), alb, jnp.float32)
    return density, albedo


class TestAlbedoGradient:
    def test_matches_fixed_seed_finite_differences(self):
        """RR off ⇒ trajectories independent of albedo ⇒ same-seed FD is
        exact for the albedo gradient."""
        density, albedo = grids()
        settings = settings_nr()
        spp, seed = 8, 3

        def loss(a):
            img = render_diff(
                density, a, seed, SPEC, CAM, settings, RES, spp
            )
            return jnp.sum(img)

        g = jax.grad(loss)(albedo)
        # directional derivative along an all-ones rgb perturbation
        h = 1e-3
        direction = jnp.zeros_like(albedo).at[..., :3].set(1.0)
        f_plus = loss(albedo + h * direction)
        f_minus = loss(albedo - h * direction)
        fd = (f_plus - f_minus) / (2 * h)
        analytic = jnp.sum(g * direction)
        np.testing.assert_allclose(
            float(analytic), float(fd), rtol=2e-2, atol=1e-3
        )

    def test_albedo_gradient_is_positive(self):
        """More albedo → brighter image, so dL/da >= 0 elementwise-summed."""
        density, albedo = grids()
        settings = settings_nr()

        def loss(a):
            return jnp.sum(
                render_diff(density, a, 1, SPEC, CAM, settings, RES, 4)
            )

        g = jax.grad(loss)(albedo)
        assert float(jnp.sum(g)) > 0.0


class TestDensityGradient:
    def test_matches_analytic_transmittance_derivative(self):
        """Absorption-only: E[pixel] = exp(-scale*rho*L); the summed
        density gradient must match dE/drho analytically."""
        n = 4
        rho = 0.5
        density = jnp.full((n, n, n), rho, jnp.float32)
        albedo = jnp.zeros((n, n, n, 4), jnp.float32)
        settings = settings_nr(max_len=8)
        spp = 2500  # 4x4 px * 2500 = 40k paths

        def loss(dgrid):
            img = render_diff(
                dgrid, albedo, 11, SPEC, CAM, settings, RES, spp
            )
            return jnp.mean(img[..., 0]) / spp

        val, g = jax.value_and_grad(loss)(density)
        # Central rays traverse L ≈ 1 through the unit box: E ≈ exp(-2*rho)
        expected_val = np.exp(-2.0 * rho)
        assert abs(float(val) - expected_val) < 0.03
        # directional derivative along uniform density shift
        dE_drho = -2.0 * np.exp(-2.0 * rho)  # -scale*L*exp(-scale*rho*L)
        total = float(jnp.sum(g))
        assert abs(total - dE_drho) / abs(dE_drho) < 0.15, (
            f"score-function density grad {total} vs analytic {dE_drho}"
        )

    def test_density_gradient_sign(self):
        """Denser absorbing medium → darker image: summed grad < 0."""
        density, _ = grids(rho=0.4)
        albedo = jnp.zeros((4, 4, 4, 4), jnp.float32)
        settings = settings_nr(max_len=8)

        def loss(dgrid):
            return jnp.sum(
                render_diff(dgrid, albedo, 5, SPEC, CAM, settings, RES, 64)
            )

        g = jax.grad(loss)(density)
        assert float(jnp.sum(g)) < 0.0


class TestPerVoxelGradients:
    def test_per_voxel_density_grad_sign_pattern(self):
        """Per-voxel check: absorption gradients are nonpositive and
        concentrate in voxels the beam traverses."""
        n = 4
        density = jnp.full((n, n, n), 0.5, jnp.float32)
        albedo = jnp.zeros((n, n, n, 4), jnp.float32)
        settings = settings_nr(max_len=8)

        def loss(dgrid):
            img = render_diff(
                dgrid, albedo, 31, SPEC, CAM, settings, RES, 400
            )
            return jnp.mean(img[..., 0]) / 400

        g = np.asarray(jax.grad(loss)(density))
        assert g.sum() < 0
        # the camera beam is a narrow pencil through the volume center in
        # x/y: central voxels must dominate the corner voxels
        center = np.abs(g[:, 1:3, 1:3]).sum()
        corners = (
            np.abs(g[:, 0, 0]).sum() + np.abs(g[:, -1, -1]).sum()
        )
        assert center > corners

    def test_pixel_gradient_allclose_rate(self):
        """BASELINE.json metric: fraction of per-pixel directional
        derivatives matching finite differences.  Uses the albedo
        parameter where same-seed FD is exact (RR off)."""
        density, albedo = grids()
        settings = settings_nr()
        spp, seed = 16, 13

        def image(a):
            return render_diff(
                density, a, seed, SPEC, CAM, settings, RES, spp
            )

        direction = jnp.zeros_like(albedo).at[..., :3].set(1.0)
        _, jvp_like = jax.vjp(image, albedo)
        # directional derivative per pixel via vjp probing each pixel
        h = 1e-3
        fd = (image(albedo + h * direction) - image(albedo - h * direction)
              ) / (2 * h)
        # analytic directional derivative: sum_c g_c via per-pixel vjp
        img_shape = fd.shape
        n_checked = 0
        n_ok = 0
        rs = np.random.RandomState(0)
        for _ in range(10):
            i, j, c = (
                rs.randint(img_shape[0]), rs.randint(img_shape[1]),
                rs.randint(3),
            )
            ct = jnp.zeros(img_shape).at[i, j, c].set(1.0)
            (grad_a,) = jvp_like(ct)
            analytic = float(jnp.sum(grad_a * direction))
            expected = float(fd[i, j, c])
            n_checked += 1
            if abs(analytic - expected) <= 0.05 * abs(expected) + 1e-3:
                n_ok += 1
        rate = n_ok / n_checked
        assert rate >= 0.9, f"pixel-grad allclose rate {rate}"


class TestInverseRecovery:
    def test_one_gradient_step_reduces_loss(self):
        """A gradient step on a perturbed density moves the render toward
        the target (tiny end-to-end inverse problem)."""
        density, albedo = grids(rho=0.5, alb=0.0)
        settings = settings_nr(max_len=8)
        spp = 256

        target = render_diff(
            density, albedo, 21, SPEC, CAM, settings, RES, spp
        ) / spp

        def loss(d):
            img = render_diff(
                d, albedo, 22, SPEC, CAM, settings, RES, spp
            ) / spp
            return jnp.mean((img - target) ** 2)

        d0 = density * 1.6
        l0, g = jax.value_and_grad(loss)(d0)
        d1 = jnp.clip(d0 - 25.0 * g, 0.0, 1.0)
        l1 = loss(d1)
        assert float(l1) < float(l0), (float(l0), float(l1))


class TestTwoLevelGradients:
    """The sparse-leap stochastic-tap estimator (two_level=True) must
    satisfy the same oracles as the naive-replay estimator."""

    def test_density_matches_analytic_transmittance_derivative(self):
        n = 4
        rho = 0.5
        density = jnp.full((n, n, n), rho, jnp.float32)
        albedo = jnp.zeros((n, n, n, 4), jnp.float32)
        settings = settings_nr(max_len=8)
        spp = 2500

        def loss(dgrid):
            img = render_diff(
                dgrid, albedo, 11, SPEC, CAM, settings, RES, spp, True
            )
            return jnp.mean(img[..., 0]) / spp

        val, g = jax.value_and_grad(loss)(density)
        expected_val = np.exp(-2.0 * rho)
        assert abs(float(val) - expected_val) < 0.03
        dE_drho = -2.0 * np.exp(-2.0 * rho)
        total = float(jnp.sum(g))
        assert abs(total - dE_drho) / abs(dE_drho) < 0.15, (
            f"2L density grad {total} vs analytic {dE_drho}"
        )

    def test_albedo_matches_fixed_seed_finite_differences(self):
        """RR off ⇒ trajectories independent of albedo ⇒ same-seed FD is
        exact for the 2L albedo gradient too."""
        density, albedo = grids()
        settings = settings_nr()
        spp, seed = 8, 3

        def loss(a):
            img = render_diff(
                density, a, seed, SPEC, CAM, settings, RES, spp, True
            )
            return jnp.sum(img)

        g = jax.grad(loss)(albedo)
        h = 1e-3
        direction = jnp.zeros_like(albedo).at[..., :3].set(1.0)
        fd = (loss(albedo + h * direction) - loss(albedo - h * direction)) / (
            2 * h
        )
        analytic = jnp.sum(g * direction)
        np.testing.assert_allclose(
            float(analytic), float(fd), rtol=2e-2, atol=1e-3
        )

    def test_forward_matches_naive_estimator_mean(self):
        """2L forward is a different (but exact) estimator: means agree."""
        density, albedo = grids(rho=0.6, alb=0.7)
        settings = settings_nr(max_len=16)
        a = render_diff(
            density, albedo, 3, SPEC, CAM, settings, RES, 256
        )
        b = render_diff(
            density, albedo, 4, SPEC, CAM, settings, RES, 256, True
        )
        ma, mb = float(jnp.mean(a)), float(jnp.mean(b))
        assert abs(ma - mb) / ma < 0.05, (ma, mb)


class TestFusedReplay:
    """The fused single-loop 2L replay must be BIT-IDENTICAL to the
    nested (bounce-lockstep) replay: identical per-lane draw sequences
    by construction (round-4, PERF.md fwd+bwd anatomy)."""

    def test_fused_replay_matches_nested(self):
        from cudavolumerenderer_tpu.models.differentiable import (
            _build_brick_tab,
            _lane_setup,
            _replay,
        )

        density, albedo = grids()
        settings = settings_nr(max_len=12)
        scene = SPEC.build(density, albedo)
        tables = _build_brick_tab(density)
        cam_obj = CAM.build()
        n_lanes, image_id, o0, d0, rng = _lane_setup(
            cam_obj, RES, 4, 123
        )
        zd = jnp.zeros((density.size,), jnp.float32)
        za = jnp.zeros((density.size, 4), jnp.float32)
        s_lane = jnp.ones((n_lanes,), jnp.float32) * 0.5
        g_lane = jnp.ones((n_lanes, 3), jnp.float32) * 0.25
        outs = {}
        for fused in (False, True):
            outs[fused] = _replay(
                scene, settings, o0, d0, rng, s_lane, g_lane, True,
                zd, za, tables, fused=fused,
            )
        # per-lane quantities (radiance/throughput) are order-invariant
        # within a lane and must be bit-equal; the cotangent buffers
        # accumulate the SAME per-lane contributions but the fused and
        # nested replays partition them into different .at[].add calls
        # (per-iteration vs per-bounce), so float accumulation grouping
        # can differ when multiple lanes hit one voxel — those get a
        # tight allclose, not bit-equality
        for field in ("radiance", "throughput"):
            a = np.asarray(getattr(outs[False], field))
            b = np.asarray(getattr(outs[True], field))
            np.testing.assert_array_equal(a, b, err_msg=field)
        for field in ("d_density", "d_albedo"):
            a = np.asarray(getattr(outs[False], field))
            b = np.asarray(getattr(outs[True], field))
            np.testing.assert_allclose(
                a, b, rtol=1e-6, atol=1e-6, err_msg=field
            )
        for field in ("o", "d"):
            a = np.asarray(getattr(outs[False], field))
            b = np.asarray(getattr(outs[True], field))
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=field)

    def test_cascade_replay_matches_uncascaded(self):
        """The cascaded replay (shrinking pools + lane-id-preserving
        compaction, round 5) must reproduce the single-pool fused
        replay: per-lane draws travel with the lane through
        compaction, so radiance/throughput are bit-identical; the
        cotangent buffers see different scatter partitions (per-pool
        vs one pool) and get a tight allclose.  min_width is forced
        tiny so several compactions actually happen at test size."""
        from cudavolumerenderer_tpu.models.differentiable import (
            _build_brick_tab,
            _lane_setup,
            _replay_2l_fused,
        )

        density, albedo = grids()
        settings = settings_nr(max_len=12)
        scene = SPEC.build(density, albedo)
        tables = _build_brick_tab(density)
        cam_obj = CAM.build()
        n_lanes, image_id, o0, d0, rng = _lane_setup(
            cam_obj, RES, 4, 123
        )
        zd = jnp.zeros((density.size,), jnp.float32)
        za = jnp.zeros((density.size, 4), jnp.float32)
        s_lane = jnp.ones((n_lanes,), jnp.float32) * 0.5
        g_lane = jnp.ones((n_lanes, 3), jnp.float32) * 0.25
        outs = {}
        for casc in (False, True):
            outs[casc] = _replay_2l_fused(
                scene, settings, o0, d0, rng, s_lane, g_lane, True,
                zd, za, tables, cascade=casc, min_width=64,
            )
        for field in ("radiance", "throughput"):
            np.testing.assert_array_equal(
                np.asarray(getattr(outs[False], field)),
                np.asarray(getattr(outs[True], field)),
                err_msg=field,
            )
        for field in ("d_density", "d_albedo", "o", "d"):
            np.testing.assert_allclose(
                np.asarray(getattr(outs[False], field)),
                np.asarray(getattr(outs[True], field)),
                rtol=1e-6, atol=1e-6, err_msg=field,
            )

    def test_fused_replay_matches_nested_with_rr(self):
        from cudavolumerenderer_tpu.models.differentiable import (
            _build_brick_tab,
            _lane_setup,
            _replay,
        )

        density, albedo = grids()
        settings = RenderSettings.from_flags(
            True, russian_roulette=True, max_path_length=16
        )
        scene = SPEC.build(density, albedo)
        tables = _build_brick_tab(density)
        cam_obj = CAM.build()
        n_lanes, image_id, o0, d0, rng = _lane_setup(
            cam_obj, RES, 2, 77
        )
        zd = jnp.zeros((density.size,), jnp.float32)
        za = jnp.zeros((density.size, 4), jnp.float32)
        zero = jnp.zeros((n_lanes,), jnp.float32)
        outs = {}
        for fused in (False, True):
            outs[fused] = _replay(
                scene, settings, o0, d0, rng, zero,
                jnp.zeros((n_lanes, 3), jnp.float32), False,
                jnp.zeros((0,), jnp.float32),
                jnp.zeros((0, 4), jnp.float32), tables, fused=fused,
            )
        np.testing.assert_array_equal(
            np.asarray(outs[False].radiance),
            np.asarray(outs[True].radiance),
        )
