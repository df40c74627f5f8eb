"""Scheduler-agreement tests.

Because every path's RNG stream is keyed by (seed, path_id) and draws are
masked per lane, each scheduling strategy computes the *same* Monte-Carlo
estimate — the wavefront analog of the reference's claim that its six kernels
run identical physics and differ only in work distribution (SURVEY.md
§2.5).  Differences are limited to float addition order in the image
scatter-add."""

import jax.numpy as jnp
import numpy as np
import pytest

from cudavolumerenderer_tpu.models import (
    naive,
    regeneration,
    streaming,
    wavefront_mk,
)
from cudavolumerenderer_tpu.ops.camera import make_camera
from cudavolumerenderer_tpu.scene import procedural
from cudavolumerenderer_tpu.scene.types import (
    RenderSettings,
    make_medium,
    make_scene,
)


def scene_and_args(res=16, spp=4, scale=40.0):
    dens = procedural.blob_volume()
    albedo = np.stack([dens, 0.5 * np.ones_like(dens), 1.0 - dens], axis=-1)
    med = make_medium(dens, albedo, scale=scale, max_density=1.0)
    scene = make_scene(med)
    camera = make_camera(res, res)
    settings = RenderSettings.from_flags(True)
    return (
        scene, camera, settings, (res, res),
        jnp.zeros(2, jnp.float32), (res, res), spp, 55, 0,
    )


class TestSchedulerAgreement:
    def test_all_schedulers_agree(self):
        args = scene_and_args()
        img_n, nr_n = naive.render_tile(*args)
        img_r, nr_r = regeneration.render_tile(*args, n_lanes=256)
        img_s, nr_s = streaming.render_tile(*args, n_lanes=256)
        np.testing.assert_allclose(
            np.asarray(img_n), np.asarray(img_r), rtol=1e-5, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(img_n), np.asarray(img_s), rtol=1e-5, atol=1e-5
        )
        # identical physics → identical ray counts
        assert float(nr_n) == float(nr_r) == float(nr_s)

    def test_sorting_variant_agrees(self):
        """sortingSK = streaming + periodic Morton lane reorder; the
        permutation must not change any path's estimate."""
        args = scene_and_args(res=8, spp=4)
        plain, nr_p = streaming.render_tile(*args, n_lanes=128)
        sorted_, nr_s = streaming.render_tile(
            *args, n_lanes=128, sort_every=4
        )
        np.testing.assert_allclose(
            np.asarray(plain), np.asarray(sorted_), rtol=1e-5, atol=1e-5
        )
        assert float(nr_p) == float(nr_s)

    def test_sorting_deferred_access_agrees(self):
        """Full sortingSK: Morton reorder + deferred coherent albedo
        fetch after the sort (SortingVolPTsk_kernel.cuh:105-147).  Lanes
        stall between scatter and fetch, but per-path draw order is
        preserved, so estimates are identical."""
        args = scene_and_args(res=8, spp=4)
        plain, nr_p = streaming.render_tile(*args, n_lanes=128)
        deferred, nr_d = streaming.render_tile(
            *args, n_lanes=128, sort_every=4, defer_access=True
        )
        np.testing.assert_allclose(
            np.asarray(plain), np.asarray(deferred), rtol=1e-5, atol=1e-5
        )
        assert float(nr_p) == float(nr_d)

    def test_sorting_deferred_no_rr(self):
        """Deferred access with Russian roulette disabled (the thesis
        benchmark setting) — flush applies only the albedo multiply."""
        args = list(scene_and_args(res=8, spp=2))
        args[2] = RenderSettings.from_flags(True, russian_roulette=False)
        plain, _ = streaming.render_tile(*args, n_lanes=64)
        deferred, _ = streaming.render_tile(
            *args, n_lanes=64, sort_every=4, defer_access=True
        )
        np.testing.assert_allclose(
            np.asarray(plain), np.asarray(deferred), rtol=1e-5, atol=1e-5
        )

    def test_regeneration_granularity_agrees(self):
        """The regeneration-granularity axis (thread/warp/block analogs:
        refill_group 1/8/1024, reference Defines.h:40-42) changes only
        queue-pull cadence, never the estimate."""
        args = scene_and_args(res=8, spp=4)
        base, nr0 = regeneration.render_tile(*args, n_lanes=256)
        for group in (8, 64):
            img, nr = regeneration.render_tile(
                *args, n_lanes=256, refill_group=group
            )
            np.testing.assert_allclose(
                np.asarray(base), np.asarray(img), rtol=1e-5, atol=1e-5
            )
            assert float(nr0) == float(nr)

    def test_streaming_mk_agrees(self):
        """Real streamingMK: host-looped regenerate/extend/compact
        super-iterations (RenderKernelLauncher.cu:435-472) computes the
        identical estimate."""
        args = scene_and_args(res=8, spp=4)
        a, nr_a = streaming.render_tile(*args, n_lanes=128)
        b, nr_b = wavefront_mk.render_tile_streaming_mk(
            *args, n_lanes=128, k_steps=4
        )
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5
        )
        assert float(nr_a) == float(nr_b)

    def test_naive_mk_agrees(self):
        """Host-looped naiveMK with device compaction matches naiveSK."""
        from cudavolumerenderer_tpu.models import wavefront_mk

        args = scene_and_args(res=8, spp=2)
        a, nr_a = naive.render_tile(*args)
        b, nr_b = wavefront_mk.render_tile(*args)
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5
        )
        assert float(nr_a) == float(nr_b)

    def test_naive_mk_without_compaction(self):
        from cudavolumerenderer_tpu.models import wavefront_mk

        args = scene_and_args(res=8, spp=2)
        a, _ = wavefront_mk.render_tile(*args, compaction=True)
        b, _ = wavefront_mk.render_tile(*args, compaction=False)
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5
        )

    def test_lane_count_invariance(self):
        """The wavefront pool size must not change the estimate
        (the reference analog: grid size never changes the image)."""
        args = scene_and_args(res=8, spp=4)
        a, _ = streaming.render_tile(*args, n_lanes=64)
        b, _ = streaming.render_tile(*args, n_lanes=256)
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5
        )

    def test_tile_offset(self):
        """Rendering the full frame == stitching two half-frame tiles."""
        scene, camera, settings, _, _, full, spp, seed, base = scene_and_args(
            res=16, spp=2
        )
        full_img, _ = naive.render_tile(
            scene, camera, settings, (16, 16),
            jnp.zeros(2, jnp.float32), (16, 16), spp, seed, base,
        )
        top, _ = naive.render_tile(
            scene, camera, settings, (16, 8),
            jnp.asarray([0.0, 0.0]), (16, 16), spp, seed, base,
        )
        bottom, _ = naive.render_tile(
            scene, camera, settings, (16, 8),
            jnp.asarray([0.0, 8.0]), (16, 16), spp, seed, base,
        )
        stitched = np.concatenate([np.asarray(top), np.asarray(bottom)], axis=0)
        # Different path-id layout per tile → different sample sets, so
        # compare statistics rather than bits: same brightness field.
        assert (
            abs(stitched.mean() - np.asarray(full_img).mean())
            / np.asarray(full_img).mean()
            < 0.15
        )
