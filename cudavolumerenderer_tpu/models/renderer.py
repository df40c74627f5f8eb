"""Progressive tiled renderer driver + factory.

Replaces the reference's CudaVolPath orchestration and RendererFactory
(reference: implementation/src/CudaVolPath.cpp:13-347,
implementation/src/RendererFactory.h:13-155): builds the row-major tile
array, advances one tile per run_iterations call, accumulates raw radiance
sums per tile, and exposes get_image with the 1/iterations display scale
(reference: ImageBufferTransfer scale semantics).  The interactive GLFW
stack is replaced by offline progressive accumulation with optional
periodic frame dumps (per BASELINE.json).
"""

from __future__ import annotations

import collections
from typing import Callable, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import Config, Kernel
from ..ops.camera import Camera
from ..scene.types import Scene
from ..utils import occupancy
from . import fast, fastq, naive, regeneration, streaming, wavefront_mk


#: kernels whose render_tile is a pure jittable function of
#: (tile_offset, path_id_base) — safe to lax.map over tiles.  The MK
#: family host-loops by design (its dispatch overhead IS the strategy).
_BATCHABLE = frozenset({
    Kernel.FAST_SK, Kernel.FAST_Q, Kernel.NAIVE_SK,
    Kernel.REGENERATION_SK, Kernel.STREAMING_SK, Kernel.SORTING_SK,
})

#: module-level batched-dispatch cache, keyed by every config value the
#: computation depends on (see _batched_cache_key): a per-instance
#: cache re-traces each trial's fresh renderer, and a re-trace of the
#: all-tiles program costs seconds to minutes of compile.  LRU-bounded
#: so long config sweeps don't accumulate jitted executables without
#: limit.
_BATCHED_FN_CACHE: collections.OrderedDict = collections.OrderedDict()
_BATCHED_FN_CACHE_CAP = 64


def clear_batched_cache() -> None:
    """Explicit hook for sweep drivers to drop compiled dispatches."""
    _BATCHED_FN_CACHE.clear()


def _tile_array(
    n_tiles: Tuple[int, int], tile_dim: Tuple[int, int]
) -> List[Tuple[int, int]]:
    """Row-major tile origins (reference: initTileArray,
    CudaVolPath.cpp:13-29)."""
    return [
        (tile_dim[0] * (i % n_tiles[0]), tile_dim[1] * (i // n_tiles[0]))
        for i in range(n_tiles[0] * n_tiles[1])
    ]


class ProgressiveTiledRenderer:
    """The single algorithm (reference: CudaVolPath) over any scheduler.

    Progressive contract mirrors AbstractProgressiveRenderer
    (reference: AbstractRenderer.h:14-24): init_rendering →
    {run_iterations; get_image}* until image_complete.
    """

    def __init__(self, scene: Scene, camera: Camera, config: Config):
        self.scene = scene
        self.camera = camera
        self.config = config
        self.settings = config.settings
        tiling = config.tiling
        self.tile_dim = tiling.tile_dim
        self.tiles = _tile_array(config.n_tiles, self.tile_dim)
        grid_shape = scene.medium.density.data.shape
        if config.n_lanes is None:
            # occupancy auto-tune (reference: Occupancy.cuh:24-70 via
            # RenderKernelLauncher init): pool width from the per-tile
            # work and the device memory budget
            config.n_lanes = occupancy.pick_n_lanes(
                self.tile_dim[0] * self.tile_dim[1],
                config.iterations, grid_shape,
            )
        else:
            occupancy.validate_pool(config.n_lanes, grid_shape)
        self.kernel_fn = make_kernel_fn(config)
        self.init_rendering()

    # -- progressive interface -------------------------------------------
    def init_rendering(self) -> None:
        w, h = self.config.resolution
        # device-resident accumulator: tiles add on-device and the image
        # crosses to the host once, at get_image (the per-tile readback
        # dominated small-render driver timings)
        self._accum_dev = jnp.zeros((h, w, 3), jnp.float32)
        self._n_rays_dev = jnp.zeros((), jnp.float32)
        self.iterations_done = np.zeros(len(self.tiles), np.int64)
        self.current_tile = 0
        self.path_id_base = 0

    @property
    def accum(self) -> np.ndarray:
        return np.asarray(self._accum_dev)

    @property
    def n_rays(self) -> float:
        return float(self._n_rays_dev)

    def image_complete(self) -> bool:
        return bool(
            np.all(self.iterations_done >= self.config.iterations)
        )

    def run_iterations(self, spp: Optional[int] = None) -> None:
        """Render one tile's next batch of iterations
        (reference: CudaVolPath::runIterations, CudaVolPath.cpp:249-280)."""
        cfg = self.config
        idx = self.current_tile
        remaining = cfg.iterations - int(self.iterations_done[idx])
        if remaining <= 0:
            self.current_tile = (idx + 1) % len(self.tiles)
            return
        spp = min(spp or cfg.iterations, remaining)

        ox, oy = self.tiles[idx]
        tw, th = self.tile_dim
        w, hres = cfg.resolution
        # clip tile to image (ceil-division tiles may overhang)
        cw, ch = min(tw, w - ox), min(th, hres - oy)

        tile_img, n_rays = self.kernel_fn(
            self.scene,
            self.camera,
            self.settings,
            (tw, th),
            jnp.asarray([float(ox), float(oy)], jnp.float32),
            (w, hres),
            spp,
            cfg.seed,
            self.path_id_base,
        )
        self.path_id_base += tw * th * spp
        self._n_rays_dev = self._n_rays_dev + n_rays
        self._accum_dev = self._accum_dev.at[
            oy : oy + ch, ox : ox + cw
        ].add(tile_img[:ch, :cw])
        self.iterations_done[idx] += spp
        self.current_tile = (idx + 1) % len(self.tiles)

    def run_pass(self, spp: int = 1) -> None:
        """One progressive pass over ALL tiles.

        Where the kernel is batchable this is a single device dispatch
        (lax.map over tile origins) accumulating on-device — the
        progressive analog of the batched `render()` path, so tiled
        interactive/progressive runs no longer pay one host round-trip
        per tile per pass (thesis Table 4.2's per-launch overhead).
        Bit-identical to looping `run_iterations(spp)` over every tile:
        same per-tile kernel calls, same path-id assignment.  A pass
        always starts at tile 0 (matching the batched dispatch's
        row-major path-id order); with uneven per-tile progress (public
        run_iterations calls mixed in) the batched path is skipped —
        it would add spp to every tile including completed ones — and
        the sequential loop clamps per tile instead."""
        self.current_tile = 0
        spp = min(spp, self.config.iterations
                  - int(self.iterations_done.min()))
        if spp <= 0:
            return
        uniform = int(self.iterations_done.min()) == int(
            self.iterations_done.max()
        )
        if (
            uniform
            and len(self.tiles) > 1
            and self.config.kernel in _BATCHABLE
            and self._batch_lanes_ok(spp)
        ):
            self._render_all_tiles_batched(spp)
        else:
            for _ in range(len(self.tiles)):
                self.run_iterations(spp=spp)

    def get_image(self) -> np.ndarray:
        """Accumulated radiance scaled by 1/iterations-done
        (reference: getImage + UtilityFunctors::Scale)."""
        done = max(int(self.iterations_done.min()), 1)
        return self.accum / float(done)

    # -- batch mode -------------------------------------------------------
    def render(
        self, progress_callback: Optional[Callable[[float], None]] = None
    ) -> np.ndarray:
        """Full batch render (reference: CudaVolPath::render,
        CudaVolPath.cpp:339-347).

        Multi-tile configurations run all tiles inside ONE device
        dispatch (lax.map over tile origins) — the reference pays a
        kernel launch per tile and degrades hard at small tiles (thesis
        Table 4.2: 98 s at 64x64 tiles); here the per-tile host
        round-trip disappears entirely."""
        self.render_device(progress_callback)
        return self.get_image()

    def render_device(self, progress_callback=None) -> None:
        """render() minus the final host image download: all dispatches
        issued, image left device-resident (read it with get_image).
        Benchmark protocol (cli.run_test, bench.py): fence on the
        n_rays scalar readback and download the image outside the
        timed region, as the reference's runTest times rendering apart
        from image save (Main.cpp:64-97)."""
        self.init_rendering()
        if (
            len(self.tiles) > 1
            and self.config.kernel in _BATCHABLE
            and self._batch_lanes_ok(self.config.iterations)
        ):
            self._render_all_tiles_batched(self.config.iterations)
            return
        total = len(self.tiles) * self.config.iterations
        while not self.image_complete():
            self.run_iterations(spp=self._spp_per_launch())
            if progress_callback is not None:
                progress_callback(
                    float(self.iterations_done.sum()) / total
                )

    def _batch_lanes_ok(self, spp: int) -> bool:
        tw, th = self.tile_dim
        return (
            self.config.kernel != Kernel.NAIVE_SK
            or tw * th * spp <= (1 << 22)
        )

    def _batched_cache_key(self, spp: int):
        """Everything the batched dispatch's computation depends on.
        The cache must span RENDERER INSTANCES, not just calls on one:
        run_test builds a fresh renderer per trial (the reference's
        per-trial cudaDeviceReset, Main.cpp:60), and a fresh jax.jit
        closure re-traces and recompiles the whole all-tiles program
        on every trial, which would dominate a trial's timed render."""
        c = self.config
        return (
            c.kernel, self.settings, self.tile_dim, c.resolution,
            c.n_tiles, spp, c.two_level, c.lanes_per_pixel, c.defer_ggx,
            c.brick_major, c.cascade_factor, c.effective_table_bits,
            c.tail_single_level, c.tail_spec, c.spec_width, c.min_width,
            c.tail_bricks, c.regeneration_level, c.n_lanes,
            c.max_bricks,
        )

    def _get_batched_fn(self, spp: int):
        """Jitted all-tiles dispatch, compiled once per configuration
        and reused across render()/run_pass() calls AND across renderer
        instances (module-level cache).  seed and path-id bases are
        traced arguments so per-trial seed bumps and progressive passes
        hit the same executable."""
        key = self._batched_cache_key(spp)
        fn = _BATCHED_FN_CACHE.get(key)
        if fn is not None:
            _BATCHED_FN_CACHE.move_to_end(key)
            return fn
        import jax

        kernel_fn = self.kernel_fn
        settings = self.settings
        tw, th = self.tile_dim
        w, hres = self.config.resolution
        ntx, nty = self.config.n_tiles

        n_tiles = ntx * nty
        # fastSK renders ALL tiles in ONE cascade (multi-tile lane mode,
        # fast.render_tile with (T, 2) offsets): tiny-tile configs stop
        # paying a full cascade drain per tile (thesis Table 4.2's
        # catastrophic 64x64 rows; BASELINE config 4's 10x10).  Other
        # batchable kernels keep the sequential lax.map dispatch.
        # Bit-identical either way (same per-tile path ids and jitter).
        # Engage only in the tiny-tile regime (<=2048 px/tile): with
        # large tiles the multi pool's multi-M-lane argsort compactions
        # outweigh lax.map's sequential per-tile drains.  The threshold
        # is unmeasured on the GPU (the 1920^2 tiling cell, ROADMAP).
        use_multi = (
            self.config.kernel == Kernel.FAST_SK
            and tw * th * max(1, self.config.lanes_per_pixel) <= 2048
            and n_tiles * tw * th
            * max(1, self.config.lanes_per_pixel) <= (1 << 22)
        )

        def batched(scene, camera, offsets, bases, seed):
            if use_multi:
                imgs, nr = kernel_fn(
                    scene, camera, settings, (tw, th), offsets,
                    (w, hres), spp, seed, bases,
                )  # (T, th, tw, 3)
                nrs = nr
            else:
                def one(args):
                    off, base = args
                    return kernel_fn(
                        scene, camera, settings, (tw, th), off,
                        (w, hres), spp, seed, base,
                    )

                imgs, nrs = jax.lax.map(one, (offsets, bases))
            # row-major tile array → padded image → crop to resolution
            padded = (
                imgs.reshape(nty, ntx, th, tw, 3)
                .transpose(0, 2, 1, 3, 4)
                .reshape(nty * th, ntx * tw, 3)
            )
            return padded[:hres, :w], jnp.sum(nrs)

        fn = jax.jit(batched)
        _BATCHED_FN_CACHE[key] = fn
        while len(_BATCHED_FN_CACHE) > _BATCHED_FN_CACHE_CAP:
            _BATCHED_FN_CACHE.popitem(last=False)
        return fn

    def _render_all_tiles_batched(self, spp: int) -> None:
        """One dispatch for every tile: lax.map over (origin, id-base),
        on-device image assembly.  Bit-identical to the sequential tile
        loop (same per-tile kernel calls, same path ids)."""
        cfg = self.config
        tw, th = self.tile_dim
        offsets = jnp.asarray(self.tiles, jnp.float32)  # (T, 2)
        bases = (
            jnp.asarray(self.path_id_base, jnp.uint32)
            + jnp.arange(len(self.tiles), dtype=jnp.uint32)
            * jnp.uint32(tw * th * spp)
        )
        img, nr = self._get_batched_fn(spp)(
            self.scene, self.camera, offsets, bases,
            jnp.uint32(cfg.seed),
        )
        self._accum_dev = self._accum_dev + img
        self._n_rays_dev = self._n_rays_dev + nr
        self.path_id_base += len(self.tiles) * tw * th * spp
        self.iterations_done += spp

    def _spp_per_launch(self) -> int:
        if self.config.kernel in (Kernel.NAIVE_SK, Kernel.NAIVE_MK):
            # bound lane memory: pixels × spp lanes materialized at once
            return max(1, min(self.config.spp_per_launch,
                              self.config.iterations))
        return self.config.iterations


def make_kernel_fn(config: Config):
    """Scheduler dispatch (reference: RendererFactory::createRenderer's
    6-kernel matrix, RendererFactory.h:43-113)."""
    k = config.kernel
    if (
        config.settings.boundary == "variable"
        and k in (Kernel.FAST_SK, Kernel.FAST_Q)
    ):
        raise ValueError(
            "--boundary variable is supported by the integrator-family "
            "schedulers (naiveSK/naiveMK/regenerationSK/streamingSK/"
            "streamingMK/sortingSK); fastSK/fastQ fused tables "
            "keep the AABB boundary"
        )
    if k == Kernel.FAST_SK:
        def fsk(*args):
            return fast.render_tile(
                *args, two_level=config.two_level,
                lanes_per_pixel=config.lanes_per_pixel,
                defer_ggx=config.defer_ggx,
                brick_major=config.brick_major,
                cascade_factor=config.cascade_factor,
                tail_single_level=config.tail_single_level,
                tail_spec=config.tail_spec,
                spec_width=config.spec_width,
                min_width=config.min_width,
                tail_bricks=config.tail_bricks,
                table_bits=config.effective_table_bits,
                **(
                    {"max_bricks": config.max_bricks}
                    if config.max_bricks is not None else {}
                ),
            )
        return fsk
    if k == Kernel.FAST_Q:
        def fq(*args):
            return fastq.render_tile(
                *args, n_lanes=config.n_lanes,
                two_level=config.two_level,
            )
        return fq
    if k == Kernel.NAIVE_SK:
        return naive.render_tile
    if k == Kernel.NAIVE_MK:
        return wavefront_mk.render_tile
    if k == Kernel.REGENERATION_SK:
        group = {0: 1, 1: 8, 2: 1024}[config.regeneration_level]

        def regen(*args):
            return regeneration.render_tile(
                *args, n_lanes=config.n_lanes, refill_group=group
            )
        return regen
    if k == Kernel.STREAMING_SK:
        def stream(*args):
            return streaming.render_tile(*args, n_lanes=config.n_lanes)
        return stream
    if k == Kernel.SORTING_SK:
        def sort(*args):
            # Morton reorder + deferred coherent albedo access — the two
            # halves of the reference strategy
            # (SortingVolPTsk_kernel.cuh:105-176)
            return streaming.render_tile(
                *args, n_lanes=config.n_lanes, sort_every=8,
                defer_access=True,
            )
        return sort
    if k == Kernel.STREAMING_MK:
        def stream_mk(*args):
            # host-looped regenerate/extend/compact super-iterations with
            # a device→host active-count sync per dispatch (reference:
            # RenderKernelLauncher.cu:435-472)
            return wavefront_mk.render_tile_streaming_mk(
                *args, n_lanes=max(1024, config.n_lanes // 8)
            )
        return stream_mk
    raise ValueError(f"unhandled kernel {k}")


def create_renderer(
    scene: Scene, camera: Camera, config: Config
) -> ProgressiveTiledRenderer:
    return ProgressiveTiledRenderer(scene, camera, config)
