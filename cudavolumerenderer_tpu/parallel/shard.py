"""Sharded rendering and sharded inverse-rendering steps.

The multi-chip re-expression of the reference's parallelism (SURVEY.md
§2.8): samples (paths) are sharded across the 'rays' mesh axis — each
device renders a disjoint set of sample indices for the same image with
its own deterministic RNG streams — and per-device partial images are
summed with psum over NVLink.  This is exactly the role atomicVectorAdd on
d_output plays on the GPU (Utilities.cuh:15-22), lifted to the
inter-chip level.  Voxel grids are replicated; the inverse pass psums the
per-voxel cotangent grids the same way (gradient all-reduce overlapped by
XLA with the backward compute).

Because path RNG streams depend only on (seed, path_id), the sharded
image is bit-identical (modulo f32 psum order) to the single-device
image with the same total spp — the shard-invariance property tested in
tests/test_sharding.py.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.camera import Camera
from ..scene.types import RenderSettings, Scene
from ..models import fast, naive, streaming


def render_sharded(
    scene: Scene,
    camera: Camera,
    settings: RenderSettings,
    resolution: Tuple[int, int],
    spp: int,
    seed: int,
    mesh: Mesh,
    kernel: str = "streaming",
    n_lanes: int = 1 << 16,
    two_level: bool = False,
    lanes_per_pixel: int = 1,
    tile_dim: Tuple[int, int] = None,
    tile_offset=None,
    path_id_base: int = 0,
    **fast_kwargs,
):
    """Render `spp` total samples/pixel sharded over the mesh's 'rays'
    axis.  Returns (image, n_rays) replicated on all devices.

    kernel: 'streaming' | 'naive' | 'fast' (the flagship scheduler,
    optionally with two-level sparse-leap tracking).  Sample path ids
    are contiguous blocks per shard, so the union over shards is the
    same id set a single-device render uses — shard invariance holds by
    construction for every kernel.

    spp need not divide the mesh size: spp = q*n_dev + r renders the q
    blocks sharded as usual, then the r remainder samples in a second
    dispatch whose per-device images are masked to shard 0 before the
    psum (every device traces the same static program — an SPMD
    requirement — but only shard 0's remainder contributes, so the path
    id union is exactly the single-device id set and shard invariance
    still holds bit-for-bit).

    Extra keyword arguments are forwarded to fast.render_tile (kernel
    knobs: cascade_factor, tail_spec, spec_width, min_width, ... — the
    same tuning surface renderer.make_kernel_fn exposes), so sharded
    renders run the measured-best configuration, not the defaults.

    tile_dim/tile_offset render one tile of a larger `resolution` image
    (the progressive tiled path, CudaVolPath.cpp:249-280, sharded): the
    returned image has tile_dim shape."""
    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    spp_shard = spp // n_dev
    spp_rem = spp - spp_shard * n_dev
    if tile_dim is None:
        tile_dim = resolution
    if tile_offset is None:
        tile_offset = jnp.zeros(2, jnp.float32)
    w, h = tile_dim
    n_pix = w * h

    def render_one(scene_r, camera_r, tile_off_r, spp_n, base):
        if kernel == "fast":
            return fast.render_tile(
                scene_r, camera_r, settings, tile_dim,
                tile_off_r, resolution, spp_n, seed,
                base, lanes_per_pixel=lanes_per_pixel,
                two_level=two_level, **fast_kwargs,
            )
        if kernel == "streaming":
            return streaming.render_tile(
                scene_r, camera_r, settings, tile_dim,
                tile_off_r, resolution, spp_n, seed,
                base, n_lanes=min(n_lanes, n_pix * spp_n),
            )
        return naive.render_tile(
            scene_r, camera_r, settings, tile_dim,
            tile_off_r, resolution, spp_n, seed, base,
        )

    def shard_fn(scene_r, camera_r, tile_off_r):
        idx = jax.lax.axis_index(axis)
        img = jnp.zeros((h, w, 3), jnp.float32)
        n_rays = jnp.zeros((), jnp.float32)
        if spp_shard > 0:
            base = (
                jnp.uint32(path_id_base)
                + (idx * n_pix * spp_shard).astype(jnp.uint32)
            )
            img, n_rays = render_one(
                scene_r, camera_r, tile_off_r, spp_shard, base
            )
        if spp_rem > 0:
            base_rem = jnp.uint32(path_id_base + n_pix * spp_shard * n_dev)
            img_r, rays_r = render_one(
                scene_r, camera_r, tile_off_r, spp_rem, base_rem
            )
            keep = (idx == 0).astype(jnp.float32)
            img = img + img_r * keep
            n_rays = n_rays + rays_r * keep
        img = jax.lax.psum(img, axis)
        n_rays = jax.lax.psum(n_rays, axis)
        return img, n_rays

    fn = jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(scene, camera, jnp.asarray(tile_offset, jnp.float32))


def make_inverse_step(
    scene_spec,
    camera_spec,
    settings: RenderSettings,
    resolution: Tuple[int, int],
    spp_per_device: int,
    mesh: Mesh,
    optimizer,
    two_level: bool = False,
):
    """Build the sharded inverse-rendering training step.

    Per device: render with device-local sample streams, compute MSE to
    the target, backprop through the path-replay custom_vjp
    (models/differentiable.py), then psum the per-voxel gradients across
    the 'rays' axis — the all-reduce the reference never needed but
    BASELINE.json demands for the differentiable pass.  two_level=True
    runs the sparse-leap stochastic-tap estimator family — the one
    big-grid recoveries (BASELINE config 5, 256^3+) require.  Returns a
    jitted step: (params, opt_state, target, seed) →
    (params, opt_state, loss).
    """
    from ..models.differentiable import render_diff

    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    w, h = resolution
    n_pix = w * h

    def per_device_loss(density, albedo, target, seed):
        img = render_diff(
            density, albedo, seed, scene_spec, camera_spec, settings,
            resolution, spp_per_device, two_level,
        ) / float(spp_per_device)
        return jnp.mean((img - target) ** 2)

    def shard_grads(density, albedo, target, seed):
        idx = jax.lax.axis_index(axis)
        # distinct sample streams per device via a device-salted seed
        dev_seed = seed + idx * jnp.uint32(0x9E3779B9)
        loss, grads = jax.value_and_grad(per_device_loss, argnums=(0, 1))(
            density, albedo, target, dev_seed
        )
        loss = jax.lax.pmean(loss, axis)
        g_density = jax.lax.pmean(grads[0], axis)
        g_albedo = jax.lax.pmean(grads[1], axis)
        return loss, g_density, g_albedo

    sharded = jax.shard_map(
        shard_grads, mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )

    @jax.jit
    def step(params, opt_state, target, seed):
        density, albedo = params
        loss, g_density, g_albedo = sharded(
            density, albedo, target, jnp.asarray(seed, jnp.uint32)
        )
        updates, opt_state = optimizer.update(
            (g_density, g_albedo), opt_state, params
        )
        import optax

        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step
