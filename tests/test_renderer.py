"""ProgressiveTiledRenderer: batched on-device tile dispatch must equal
the sequential per-tile loop exactly (same kernel calls, same path ids),
including ragged edges where ceil-division tiles overhang the image."""

import numpy as np
import pytest

from cudavolumerenderer_tpu.config import Config, Kernel
from cudavolumerenderer_tpu.models.renderer import create_renderer
from cudavolumerenderer_tpu.ops.camera import make_camera
from cudavolumerenderer_tpu.scene import procedural
from cudavolumerenderer_tpu.scene.types import (
    RenderSettings,
    make_medium,
    make_scene,
)


def _scene():
    d = procedural.blob_volume((16, 16, 16), n_blobs=3)
    return make_scene(make_medium(d, 0.8, scale=20.0, max_density=1.0))


def _render_sequential(scene, camera, config):
    r = create_renderer(scene, camera, config)
    r.init_rendering()
    while not r.image_complete():
        r.run_iterations(spp=r._spp_per_launch())
    return r.get_image(), r.n_rays


@pytest.mark.parametrize(
    "kernel", [Kernel.FAST_SK, Kernel.STREAMING_SK, Kernel.NAIVE_SK]
)
@pytest.mark.parametrize("tiles,res", [((2, 2), 16), ((3, 2), 20)])
def test_batched_tiles_equal_sequential(kernel, tiles, res):
    scene = _scene()
    camera = make_camera(res, res)
    cfg = dict(
        kernel=kernel, iterations=4, resolution=(res, res),
        n_tiles=tiles, n_lanes=256,
        settings=RenderSettings.from_flags(True),
    )
    img_seq, nr_seq = _render_sequential(scene, camera, Config(**cfg))
    r = create_renderer(scene, camera, Config(**cfg))
    img_bat = r.render()
    assert r.image_complete()
    np.testing.assert_allclose(img_bat, img_seq, rtol=1e-6, atol=1e-6)
    assert float(r.n_rays) == float(nr_seq)


def test_ragged_tiles_cover_image():
    """20x20 image with 3x3 ceil-division tiles (7x7 tile dim, one-pixel
    overhang per edge): every pixel rendered exactly once."""
    scene = _scene()
    res = 20
    camera = make_camera(res, res)
    cfg = Config(
        kernel=Kernel.FAST_SK, iterations=2, resolution=(res, res),
        n_tiles=(3, 3),
        settings=RenderSettings.from_flags(True, russian_roulette=False),
    )
    r = create_renderer(scene, camera, cfg)
    img = r.render()
    assert img.shape == (res, res, 3)
    assert np.isfinite(img).all()
    # RR off + constant environment: every path escapes with positive
    # throughput, so no pixel can stay black
    assert (img > 0).all()


def test_progressive_pass_batched_equals_sequential():
    """run_pass(spp) (one dispatch over all tiles) must match looping
    run_iterations(spp) over every tile bit-for-bit, across multiple
    progressive passes (the interactive/tiled flow)."""
    scene = _scene()
    res = 16
    camera = make_camera(res, res)
    cfg = dict(
        kernel=Kernel.FAST_SK, iterations=4, resolution=(res, res),
        n_tiles=(2, 2), n_lanes=256,
        settings=RenderSettings.from_flags(True),
    )
    r_seq = create_renderer(scene, camera, Config(**cfg))
    r_seq.init_rendering()
    r_bat = create_renderer(scene, camera, Config(**cfg))
    r_bat.init_rendering()
    for _ in range(2):  # two progressive passes of 2 spp each
        for _ in range(len(r_seq.tiles)):
            r_seq.run_iterations(spp=2)
        r_bat.run_pass(2)
        np.testing.assert_array_equal(
            np.asarray(r_bat.accum), np.asarray(r_seq.accum)
        )
        assert r_bat.path_id_base == r_seq.path_id_base
    assert r_bat.image_complete() and r_seq.image_complete()
    # a further pass is a no-op once complete
    r_bat.run_pass(1)
    np.testing.assert_array_equal(
        np.asarray(r_bat.accum), np.asarray(r_seq.accum)
    )


def test_run_pass_uneven_progress_respects_iteration_cap():
    """Mixing public run_iterations with run_pass must never render a
    tile past config.iterations (an earlier batched pass added
    spp to EVERY tile, re-brightening completed ones)."""
    scene = _scene()
    res = 16
    camera = make_camera(res, res)
    cfg = dict(
        kernel=Kernel.FAST_SK, iterations=2, resolution=(res, res),
        n_tiles=(2, 2), n_lanes=256,
        settings=RenderSettings.from_flags(True),
    )
    r = create_renderer(scene, camera, Config(**cfg))
    r.init_rendering()
    # tile 0 renders all its iterations up front -> uneven progress
    r.run_iterations(spp=2)
    assert list(r.iterations_done) == [2, 0, 0, 0]
    r.run_pass(2)
    assert list(r.iterations_done) == [2, 2, 2, 2]
    assert r.image_complete()
    # reference: a renderer driven purely by run_pass
    r2 = create_renderer(scene, camera, Config(**cfg))
    r2.init_rendering()
    r2.run_pass(2)
    np.testing.assert_array_equal(np.asarray(r.accum), np.asarray(r2.accum))


def test_render_device_matches_render():
    """render_device + get_image must equal render() exactly: the
    benchmark protocol (cli.run_test) fences on the device ray counter
    and downloads the image outside the timed region — same pixels,
    same ray count."""
    scene = _scene()
    camera = make_camera(16, 16)
    cfg = dict(
        kernel=Kernel.FAST_SK, iterations=3, resolution=(16, 16),
        n_tiles=(2, 2), two_level=True,
        settings=RenderSettings.from_flags(True),
    )
    r1 = create_renderer(scene, camera, Config(**cfg))
    img1 = r1.render()
    r2 = create_renderer(scene, camera, Config(**cfg))
    r2.render_device()
    nr2 = r2.n_rays  # the protocol's fence
    img2 = r2.get_image()
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))
    assert nr2 == r1.n_rays
