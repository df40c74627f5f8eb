"""Multi-device tests on the 8-device CPU mesh (SURVEY.md §4d):
shard-invariance of images, psum accumulation, and the sharded inverse
step."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from cudavolumerenderer_tpu.models import naive
from cudavolumerenderer_tpu.models.differentiable import (
    CameraSpec,
    SceneSpec,
)
from cudavolumerenderer_tpu.ops.camera import make_camera
from cudavolumerenderer_tpu.parallel.mesh import make_mesh
from cudavolumerenderer_tpu.parallel.shard import (
    make_inverse_step,
    render_sharded,
)
from cudavolumerenderer_tpu.scene import procedural
from cudavolumerenderer_tpu.scene.types import (
    RenderSettings,
    make_medium,
    make_scene,
)


def small_scene():
    dens = procedural.blob_volume((8, 8, 8), n_blobs=3)
    albedo = np.stack(
        [dens, 0.5 * np.ones_like(dens), 1.0 - dens], axis=-1
    )
    med = make_medium(dens, albedo, scale=10.0, max_density=1.0)
    return make_scene(med)


class TestShardedRender:
    def test_devices_available(self):
        assert len(jax.devices()) >= 8

    def test_shard_invariance(self):
        """The sharded image with spp total samples equals the
        single-device image with the same spp (same path ids → same
        streams), up to psum addition order."""
        scene = small_scene()
        res = (8, 8)
        camera = make_camera(*res)
        settings = RenderSettings.from_flags(True)
        spp = 8
        mesh = make_mesh(8)
        img_sharded, nrays_sharded = render_sharded(
            scene, camera, settings, res, spp, 3, mesh,
            kernel="naive",
        )
        img_single, nrays_single = naive.render_tile(
            scene, camera, settings, res, jnp.zeros(2, jnp.float32),
            res, spp, 3, 0,
        )
        np.testing.assert_allclose(
            np.asarray(img_sharded), np.asarray(img_single),
            rtol=1e-5, atol=1e-5,
        )
        assert float(nrays_sharded) == float(nrays_single)

    @pytest.mark.parametrize("two_level", [False, True])
    def test_fast_shard_invariance(self, two_level):
        """The flagship scheduler shards too: fastSK
        with and without two-level sparse-leap tracking gives the same
        image sharded over 8 devices as on one."""
        from cudavolumerenderer_tpu.models import fast

        scene = small_scene()
        res = (8, 8)
        camera = make_camera(*res)
        settings = RenderSettings.from_flags(True)
        spp = 16
        mesh = make_mesh(8)
        img_sharded, nr_s = render_sharded(
            scene, camera, settings, res, spp, 3, mesh,
            kernel="fast", two_level=two_level,
        )
        img_single, nr_1 = fast.render_tile(
            scene, camera, settings, res, jnp.zeros(2, jnp.float32),
            res, spp, 3, 0, two_level=two_level,
        )
        np.testing.assert_allclose(
            np.asarray(img_sharded), np.asarray(img_single),
            rtol=2e-5, atol=2e-5,
        )
        assert float(nr_s) == float(nr_1)

    @pytest.mark.parametrize("spp", [5, 13])
    def test_odd_spp_shard_invariance(self, spp):
        """spp not divisible by the mesh size still shards: the
        q*n_dev + r decomposition keeps the path-id union
        identical to the single-device render, so the image is
        bit-invariant.  spp=5 < 8 devices exercises the q=0 pure-
        remainder path."""
        from cudavolumerenderer_tpu.models import fast

        scene = small_scene()
        res = (8, 8)
        camera = make_camera(*res)
        settings = RenderSettings.from_flags(True)
        mesh = make_mesh(8)
        img_sharded, nr_s = render_sharded(
            scene, camera, settings, res, spp, 3, mesh,
            kernel="fast", two_level=True,
        )
        img_single, nr_1 = fast.render_tile(
            scene, camera, settings, res, jnp.zeros(2, jnp.float32),
            res, spp, 3, 0, two_level=True,
        )
        np.testing.assert_allclose(
            np.asarray(img_sharded), np.asarray(img_single),
            rtol=2e-5, atol=2e-5,
        )
        assert float(nr_s) == float(nr_1)

    def test_fast_kernel_knobs_forwarded(self):
        """render_sharded forwards fastSK tuning knobs: a
        sharded render with explicit cascade_factor/min_width gives the
        same image (knobs change scheduling, not the estimator)."""
        from cudavolumerenderer_tpu.models import fast

        scene = small_scene()
        res = (8, 8)
        camera = make_camera(*res)
        settings = RenderSettings.from_flags(True)
        mesh = make_mesh(4)
        img_knobs, _ = render_sharded(
            scene, camera, settings, res, 8, 3, mesh,
            kernel="fast", two_level=True, cascade_factor=2,
            min_width=256,
        )
        img_single, _ = fast.render_tile(
            scene, camera, settings, res, jnp.zeros(2, jnp.float32),
            res, 8, 3, 0, two_level=True,
        )
        np.testing.assert_allclose(
            np.asarray(img_knobs), np.asarray(img_single),
            rtol=2e-5, atol=2e-5,
        )

    def test_mesh_size_invariance(self):
        """2-device and 8-device meshes give the same image."""
        scene = small_scene()
        res = (8, 8)
        camera = make_camera(*res)
        settings = RenderSettings.from_flags(True)
        img2, _ = render_sharded(
            scene, camera, settings, res, 8, 5, make_mesh(2),
            kernel="naive",
        )
        img8, _ = render_sharded(
            scene, camera, settings, res, 8, 5, make_mesh(8),
            kernel="naive",
        )
        np.testing.assert_allclose(
            np.asarray(img2), np.asarray(img8), rtol=1e-5, atol=1e-5
        )


class TestShardedInverse:
    def test_sharded_gradient_is_mean_of_device_gradients(self):
        """The sharded step's gradient equals the mean of each device's
        gradient computed alone: the MSE of its render_diff image with
        the step seed salted by the device index."""
        from cudavolumerenderer_tpu.models.differentiable import render_diff

        scene = small_scene()
        res = (8, 8)
        settings = RenderSettings.from_flags(
            True, russian_roulette=False, max_path_length=8,
        )
        spec = SceneSpec.from_scene(scene)
        cam_spec = CameraSpec(res_x=res[0], res_y=res[1], fov_x_deg=0.4)
        density = jnp.asarray(scene.medium.density.data)
        albedo = jnp.asarray(scene.medium.albedo.data)
        target = jnp.full(res + (3,), 0.3)
        seed = jnp.uint32(41)

        def zeros(tree):
            return jax.tree.map(jnp.zeros_like, tree)

        # keeps the step's gradients as its state, parameters unchanged
        capture = optax.GradientTransformation(
            zeros, lambda grads, state, params=None: (zeros(grads), grads)
        )
        step = make_inverse_step(
            spec, cam_spec, settings, res, spp_per_device=2,
            mesh=make_mesh(4), optimizer=capture, two_level=True,
        )
        params = (density, albedo)
        new_params, (gd4, ga4), loss4 = step(
            params, capture.init(params), target, seed
        )
        np.testing.assert_array_equal(np.asarray(new_params[0]), density)

        def loss(d, a, s):
            img = render_diff(
                d, a, s, spec, cam_spec, settings, res, 2, True
            ) / 2.0
            return jnp.mean((img - target) ** 2)

        vg = jax.jit(jax.value_and_grad(loss, argnums=(0, 1)))
        parts = [
            vg(density, albedo, seed + jnp.uint32(i) * jnp.uint32(0x9E3779B9))
            for i in range(4)
        ]
        np.testing.assert_allclose(
            float(loss4), np.mean([float(p[0]) for p in parts]),
            rtol=1e-6,
        )
        for k, g4 in ((0, gd4), (1, ga4)):
            g1 = np.mean([np.asarray(p[1][k]) for p in parts], axis=0)
            np.testing.assert_allclose(
                np.asarray(g4), g1, rtol=1e-5, atol=1e-7
            )

    def test_inverse_step_runs_and_descends(self):
        scene = small_scene()
        res = (8, 8)
        settings = RenderSettings.from_flags(
            True, russian_roulette=False, max_path_length=8,
            bsdf_kind="null",
        )
        spec = SceneSpec.from_scene(scene)
        cam_spec = CameraSpec(res_x=res[0], res_y=res[1], fov_x_deg=0.4)
        mesh = make_mesh(8)
        optimizer = optax.sgd(5.0)
        step = make_inverse_step(
            spec, cam_spec, settings, res, spp_per_device=32,
            mesh=mesh, optimizer=optimizer,
        )
        density = jnp.asarray(scene.medium.density.data)
        albedo = jnp.zeros_like(scene.medium.albedo.data)
        target_img = jnp.full(res + (3,), float(np.exp(-10 * 0.3)))

        params = (density, albedo)
        opt_state = optimizer.init(params)
        losses = []
        for it in range(3):
            params, opt_state, loss = step(
                params, opt_state, target_img, 100 + it
            )
            losses.append(float(loss))
        assert all(np.isfinite(losses))
        assert losses[-1] <= losses[0] * 1.05  # descending (noisy MC)
