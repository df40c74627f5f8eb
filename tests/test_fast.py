"""Tests for the fastSK wavefront scheduler: energy conservation under
stochastic trilinear filtering and statistical agreement with the
reference-faithful schedulers."""

import jax.numpy as jnp
import numpy as np
import pytest

from cudavolumerenderer_tpu.models import fast, naive
from cudavolumerenderer_tpu.ops.camera import make_camera
from cudavolumerenderer_tpu.scene import procedural
from cudavolumerenderer_tpu.scene.types import (
    RenderSettings,
    make_medium,
    make_scene,
)


def make_args(scene, res, spp, seed=9):
    camera = make_camera(res, res)
    settings = RenderSettings.from_flags(True)
    return (
        scene, camera, settings, (res, res),
        jnp.zeros(2, jnp.float32), (res, res), spp, seed, 0,
    )


def blob_scene(albedo_value=None, scale=40.0):
    dens = procedural.blob_volume()
    if albedo_value is None:
        albedo = np.stack(
            [dens, 0.5 * np.ones_like(dens), 1.0 - dens], axis=-1
        )
    else:
        albedo = np.full(dens.shape + (3,), albedo_value, np.float32)
    return make_scene(make_medium(dens, albedo, scale=scale, max_density=1.0))


class TestFast:
    def test_white_furnace_exact(self):
        """Stochastic filtering must preserve energy exactly: with unit
        albedo the filter noise cancels (albedo_hat == 1 for every tap)."""
        scene = blob_scene(albedo_value=1.0)
        camera = make_camera(16, 16)
        settings = RenderSettings.from_flags(True, bsdf_kind="null")
        img, _ = fast.render_tile(
            scene, camera, settings, (16, 16), jnp.zeros(2, jnp.float32),
            (16, 16), 4, 3, 0,
        )
        np.testing.assert_allclose(np.asarray(img) / 4, 1.0, atol=1e-5)

    def test_white_furnace_exact_tail_modes(self):
        """The tail knobs (single-level tail pools, speculative steps,
        deep chains, tiny min_width) change the draw schedule but never
        the physics: unit albedo + null bsdf still gives exactly 1.0.
        min_width is tiny and tail_width huge so every cascade stage
        actually runs the single-level spec-K path."""
        scene = blob_scene(albedo_value=1.0)
        camera = make_camera(16, 16)
        settings = RenderSettings.from_flags(True, bsdf_kind="null")
        for kw in (
            dict(tail_spec=4, tail_width=1 << 20, min_width=64),
            dict(tail_single_level=True, tail_spec=8,
                 tail_width=1 << 20, min_width=64, tail_chain=4),
        ):
            img, _ = fast.render_tile(
                scene, camera, settings, (16, 16),
                jnp.zeros(2, jnp.float32), (16, 16), 4, 3, 0,
                two_level=True, **kw,
            )
            np.testing.assert_allclose(np.asarray(img) / 4, 1.0, atol=1e-5)

    def test_tail_modes_statistical_agreement(self):
        """Single-level spec-K tail pools are the same estimator: image
        means agree with the default path within MC tolerance."""
        scene = blob_scene()
        args = make_args(scene, 24, 32)
        img_a, nr_a = fast.render_tile(*args, two_level=True)
        img_b, nr_b = fast.render_tile(
            *args, two_level=True, tail_single_level=True, tail_spec=8,
            tail_width=1 << 20, min_width=64,
        )
        a = float(np.asarray(img_a).mean())
        b = float(np.asarray(img_b).mean())
        assert abs(a - b) / a < 0.02
        assert abs(float(nr_a) - float(nr_b)) / float(nr_a) < 0.05

    def test_statistical_agreement_with_naive(self):
        """Different estimator, same mean: image means agree within MC
        tolerance at moderate spp."""
        scene = blob_scene()
        args = make_args(scene, 24, 32)
        img_n, _ = naive.render_tile(*args)
        img_f, _ = fast.render_tile(*args)
        a = float(np.asarray(img_n).mean())
        b = float(np.asarray(img_f).mean())
        assert abs(a - b) / a < 0.02

    def test_ray_counts_match_naive(self):
        """Same physics → same expected segments; counts are close (the
        stochastic filter changes which paths scatter, not the rate)."""
        scene = blob_scene()
        args = make_args(scene, 16, 16)
        _, nr_n = naive.render_tile(*args)
        _, nr_f = fast.render_tile(*args)
        assert abs(float(nr_n) - float(nr_f)) / float(nr_n) < 0.05

    def test_lanes_per_pixel_invariance(self):
        scene = blob_scene()
        args = make_args(scene, 16, 8)
        a, _ = fast.render_tile(*args, lanes_per_pixel=1)
        b, _ = fast.render_tile(*args, lanes_per_pixel=2)
        # identical path-id streams, identical estimator → identical image
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5
        )

    def test_deterministic(self):
        scene = blob_scene()
        args = make_args(scene, 16, 4)
        a, _ = fast.render_tile(*args)
        b, _ = fast.render_tile(*args)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_fractional_cascade_factor_bit_exact(self):
        """Fractional shrink factors (round 5) change only WHEN lanes
        compact, never a lane's draw stream: images are bit-identical
        across factors."""
        scene = blob_scene()
        args = make_args(scene, 16, 4)
        ref, _ = fast.render_tile(*args, cascade_factor=2, min_width=32)
        for f in (1.5, 1.25):
            img, _ = fast.render_tile(
                *args, cascade_factor=f, min_width=32
            )
            np.testing.assert_array_equal(
                np.asarray(ref), np.asarray(img), err_msg=str(f)
            )

    @pytest.mark.parametrize("chain", [2, 8])
    def test_tail_chain_bit_exact(self, chain):
        """Chaining tail evaluations changes only how often the pool's
        pending count is read: evaluations past the exit are no-ops, so
        images and ray counts are bit-identical across chain lengths."""
        scene = blob_scene()
        args = make_args(scene, 16, 4)
        kw = dict(min_width=32, tail_width=1 << 20)
        ref, ref_rays = fast.render_tile(*args, tail_chain=1, **kw)
        img, rays = fast.render_tile(*args, tail_chain=chain, **kw)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(img))
        assert float(rays) == float(ref_rays)

    def test_chain_body_is_repeated_body(self):
        body = lambda s: (s[0] * 3 + 1, s[1] + 1)
        s0 = (jnp.int32(2), jnp.int32(0))
        assert fast.chain_body(body, 1) is body
        out = fast.chain_body(body, 4)(s0)
        ref = s0
        for _ in range(4):
            ref = body(ref)
        assert [int(x) for x in out] == [int(x) for x in ref]

    def test_fractional_cascade_widths_monotone(self):
        for f in (1.25, 1.33, 1.5, 2, 4):
            w = fast._cascade_widths(262144, f, 128)
            assert w[0] == 262144 and w[-1] >= 128
            assert all(a > b for a, b in zip(w, w[1:])), (f, w)
            assert all(x % 256 == 0 or x == 128 for x in w[1:]), (f, w)


class TestTwoLevel:
    def test_furnace_exact(self):
        scene = blob_scene(albedo_value=1.0)
        camera = make_camera(16, 16)
        settings = RenderSettings.from_flags(True, bsdf_kind="null")
        img, _ = fast.render_tile(
            scene, camera, settings, (16, 16), jnp.zeros(2, jnp.float32),
            (16, 16), 4, 3, 0, two_level=True,
        )
        np.testing.assert_allclose(np.asarray(img) / 4, 1.0, atol=1e-5)

    def test_agrees_with_single_level(self):
        """Piecewise-majorant tracking is distribution-exact: means and
        segment counts match single-level within MC tolerance."""
        scene = blob_scene()
        args = make_args(scene, 24, 32)
        a, nr1 = fast.render_tile(*args, two_level=False)
        b, nr2 = fast.render_tile(*args, two_level=True)
        am, bm = float(np.asarray(a).mean()), float(np.asarray(b).mean())
        assert abs(am - bm) / am < 0.03
        assert abs(float(nr1) - float(nr2)) / float(nr1) < 0.02

    def test_brick_majorants_are_majorants(self):
        from cudavolumerenderer_tpu.models.fast import (
            BRICK,
            brick_majorants,
        )

        dens = procedural.blob_volume((20, 24, 28))
        bm = np.asarray(brick_majorants(jnp.asarray(dens)))
        bz, by, bx = BRICK
        nz, ny, nx = dens.shape
        for b_z in range(bm.shape[0]):
            for b_y in range(bm.shape[1]):
                for b_x in range(bm.shape[2]):
                    blk = dens[
                        b_z * bz : min((b_z + 1) * bz + 1, nz),
                        b_y * by : min((b_y + 1) * by + 1, ny),
                        b_x * bx : min((b_x + 1) * bx + 1, nx),
                    ]
                    assert bm[b_z, b_y, b_x] >= blk.max() - 1e-6


class TestFastQ:
    def test_furnace_exact(self):
        from cudavolumerenderer_tpu.models import fastq

        scene = blob_scene(albedo_value=1.0)
        camera = make_camera(16, 16)
        settings = RenderSettings.from_flags(True, bsdf_kind="null")
        for tl in (False, True):
            img, _ = fastq.render_tile(
                scene, camera, settings, (16, 16),
                jnp.zeros(2, jnp.float32), (16, 16), 4, 3, 0,
                n_lanes=256, two_level=tl,
            )
            np.testing.assert_allclose(np.asarray(img) / 4, 1.0, atol=1e-5)

    def test_agreement_and_ray_counts(self):
        from cudavolumerenderer_tpu.models import fastq

        scene = blob_scene()
        args = make_args(scene, 24, 32)
        a, nra = naive.render_tile(*args)
        b, nrb = fastq.render_tile(*args, n_lanes=576)
        am, bm = float(np.asarray(a).mean()), float(np.asarray(b).mean())
        assert abs(am - bm) / am < 0.02
        assert abs(float(nra) - float(nrb)) / float(nra) < 0.02

    def test_lane_count_invariance(self):
        from cudavolumerenderer_tpu.models import fastq

        scene = blob_scene()
        args = make_args(scene, 16, 8)
        a, _ = fastq.render_tile(*args, n_lanes=128)
        b, _ = fastq.render_tile(*args, n_lanes=1024)
        # same path-id streams -> identical estimates, different add order
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4
        )


class TestAffineAlbedo:
    """Affine-in-density albedo detection and the flat fused-table path."""

    def test_detection(self):
        dens = procedural.blob_volume()
        alb = np.stack([dens, 0.5 * np.ones_like(dens), 1.0 - dens], -1)
        med = make_medium(dens, alb, scale=40.0, max_density=1.0)
        assert med.albedo_affine is not None
        A, B = np.asarray(med.albedo_affine)
        np.testing.assert_allclose(A, [1.0, 0.0, -1.0], atol=1e-6)
        np.testing.assert_allclose(B, [0.0, 0.5, 1.0], atol=1e-6)
        # non-affine albedo must not be detected
        alb2 = alb.copy()
        alb2[0, 0, 0, 1] += 0.25
        med2 = make_medium(dens, alb2, scale=40.0, max_density=1.0)
        assert med2.albedo_affine is None
        # constant albedo stays on the const path, not affine
        med3 = make_medium(dens, 0.9, scale=40.0, max_density=1.0)
        assert med3.albedo_affine is None
        assert fast._albedo_mode(make_scene(med3)) == "const"

    def test_defer_ggx_bit_exact(self):
        """Deferred boundary processing (amortized batched GGX) must be
        bit-exact vs the per-iteration event path: same draws at the
        same positions in each lane's own stream, just later in wall
        time."""
        dens = procedural.blob_volume()
        alb = np.stack([dens, 0.5 * np.ones_like(dens), 1.0 - dens], -1)
        scene = make_scene(
            make_medium(dens, alb, scale=40.0, max_density=1.0)
        )
        args = make_args(scene, 24, 4)
        for tl in (False, True):
            a, nra = fast.render_tile(*args, two_level=tl)
            b, nrb = fast.render_tile(*args, two_level=tl, defer_ggx=4)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert float(nra) == float(nrb)

    def test_brick_major_table_is_permutation(self):
        """brick_major_table must be a pure re-layout: every voxel
        appears exactly once, at the index tap_flat_idx would compute."""
        rng = np.random.RandomState(3)
        dens = rng.rand(8, 16, 256).astype(np.float32)
        nz, ny, nx = dens.shape
        ez, ey, ex = fast._BM_BRICK
        tab = np.asarray(fast.brick_major_table(jnp.asarray(dens)))
        iz, iy, ix = np.meshgrid(
            np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
        )
        flat = (
            (
                ((iz >> 3) * (ny // ey) + (iy >> 3)) * (nx // ex)
                + (ix >> 7)
            )
            * (ez * ey * ex)
            + ((iz & 7) << 10) + ((iy & 7) << 7) + (ix & 127)
        )
        np.testing.assert_array_equal(tab[flat.reshape(-1)],
                                      dens.reshape(-1))

    def test_brick_major_bit_exact(self):
        """The (8,8,128) brick-major table layout changes only the
        flat-index mapping, never the fetched value: images are
        bit-identical.  Grid dims are brick multiples so the layout is
        actually exercised (smaller grids fall back to row-major)."""
        # blob_volume resolution is (x, y, z) -> density shape (16,16,128)
        dens = procedural.blob_volume((128, 16, 16), n_blobs=3)
        scene = make_scene(make_medium(dens, 0.8, scale=20.0,
                                       max_density=1.0))
        args = make_args(scene, 16, 4)
        for tl in (False, True):
            a, nra = fast.render_tile(*args, two_level=tl)
            b, nrb = fast.render_tile(
                *args, two_level=tl, brick_major=True
            )
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            assert float(nra) == float(nrb)

    def test_flat_table_matches_full_table(self):
        """The 1-channel affine table reproduces the 4-channel fused
        table to float32 rounding (same draws, same taps; the
        reconstruction A*rho+B may differ from the stored albedo by one
        ulp, and detection itself tolerates atol 2e-6)."""
        dens = procedural.blob_volume()
        alb = np.stack([dens, 0.5 * np.ones_like(dens), 1.0 - dens], -1)
        scene = make_scene(make_medium(dens, alb, scale=40.0, max_density=1.0))
        assert fast._albedo_mode(scene) == "affine"
        # full-table control: strip the detection result
        scene_full = scene._replace(
            medium=scene.medium._replace(albedo_affine=None)
        )
        assert fast._albedo_mode(scene_full) == "full"
        for tl in (False, True):
            args = make_args(scene, 24, 4)
            a, nra = fast.render_tile(*args, two_level=tl)
            args_full = make_args(scene_full, 24, 4)
            b, nrb = fast.render_tile(*args_full, two_level=tl)
            assert float(nra) == float(nrb)
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=2e-6
            )


def test_packed_table_exact_when_representable():
    """table_bits=8 packs 4 voxels per uint32 word; when the density is
    exactly representable on the 255-level grid the packed render must
    be BIT-IDENTICAL to f32 (proves the pack/unpack roundtrip), and the
    brick majorants (built from the dequantized grid) must still bound
    every tap."""
    import numpy as np

    from cudavolumerenderer_tpu.scene import procedural
    from cudavolumerenderer_tpu.scene.types import make_medium, make_scene

    # density on the dyadic grid k/256 with max_density 255/256: the
    # quantizer's dequant scale is then exactly 1/256 in float32, so
    # quantize-dequantize roundtrips bit-exactly (k/255-grid values do
    # NOT roundtrip — 1/255 is not representable)
    d = np.round(
        procedural.medical_volume((16, 16, 16), n_blobs=4) * 255
    ) / 256
    alb = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], axis=-1)
    scene = make_scene(
        make_medium(d.astype(np.float32), alb, scale=20.0,
                    max_density=255.0 / 256.0)
    )
    camera = make_camera(16, 16)
    settings = RenderSettings.from_flags(True)
    common = dict(
        tile_dim=(16, 16), tile_offset=jnp.zeros(2, jnp.float32),
        full_resolution=(16, 16), spp=4,
    )
    for two_level in (False, True):
        a, _ = fast.render_tile(scene, camera, settings, seed=7,
                                path_id_base=0, two_level=two_level,
                                **common)
        b, _ = fast.render_tile(scene, camera, settings, seed=7,
                                path_id_base=0, two_level=two_level,
                                table_bits=8, **common)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_packed_table_quantization_bounded():
    """Non-representable density: the 8-bit packed render's image mean
    must sit within ~1% of the f32 render (quantization bias bound)."""
    import numpy as np

    from cudavolumerenderer_tpu.scene import procedural
    from cudavolumerenderer_tpu.scene.types import make_medium, make_scene

    d = procedural.medical_volume((16, 16, 16), n_blobs=4)
    alb = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], axis=-1)
    scene = make_scene(
        make_medium(d, alb, scale=20.0, max_density=1.0)
    )
    camera = make_camera(16, 16)
    settings = RenderSettings.from_flags(True)
    common = dict(
        tile_dim=(16, 16), tile_offset=jnp.zeros(2, jnp.float32),
        full_resolution=(16, 16), spp=32, two_level=True,
    )
    a, _ = fast.render_tile(scene, camera, settings, seed=3,
                            path_id_base=0, **common)
    b, _ = fast.render_tile(scene, camera, settings, seed=3,
                            path_id_base=0, table_bits=8, **common)
    am, bm = float(np.asarray(a).mean()), float(np.asarray(b).mean())
    assert abs(am - bm) / am < 0.01


@pytest.mark.parametrize(
    "backend, expected",
    [("cpu", fast._MIN_WIDTH["cpu"]), ("gpu", fast._MIN_WIDTH["gpu"]),
     ("rocm", None)],
)
def test_default_min_width_per_backend(monkeypatch, backend, expected):
    """The cascade bottom is chosen per backend; a backend without a
    measured value is refused rather than given a guess."""
    monkeypatch.setattr(fast.jax, "default_backend", lambda: backend)
    if expected is None:
        with pytest.raises(ValueError, match="rocm"):
            fast._default_min_width()
    else:
        assert fast._default_min_width() == expected


def test_max_bricks_config_plumbing():
    """Config.max_bricks must reach fast.render_tile through the
    production factory: the factory render with max_bricks=64 matches
    a direct render_tile call with the same cap bit-for-bit, and
    differs from the default-cap render's RNG consumption pattern only
    statistically (both unbiased)."""
    from cudavolumerenderer_tpu.config import Config, Kernel
    from cudavolumerenderer_tpu.models.renderer import make_kernel_fn

    scene = blob_scene()
    camera = make_camera(16, 16)
    settings = RenderSettings.from_flags(True)
    common = (
        scene, camera, settings, (16, 16),
        jnp.zeros(2, jnp.float32), (16, 16), 4, 7, 0,
    )
    config = Config(kernel=Kernel.FAST_SK, two_level=True, max_bricks=64)
    fn = make_kernel_fn(config)
    a, _ = fn(*common)
    b, _ = fast.render_tile(*common, two_level=True, max_bricks=64)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
