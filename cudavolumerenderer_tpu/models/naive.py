"""Naive megakernel scheduler: one lane per path, no regeneration.

Wavefront analog of naiveSK (reference: implementation/src/NaiveVolPTsk_kernel.cuh
and its launcher, RenderKernelLauncher.cu:131-158): every path of the tile
batch gets a lane up front; the wavefront runs the shared bounce loop until
all lanes die.  Dead lanes idle until the slowest path finishes — exactly
the inefficiency the reference measures for this strategy, re-expressed as
masked lanes instead of idle CUDA threads.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops import camera as cam
from ..ops.rng import make_rng
from ..scene.types import RenderSettings, Scene
from . import integrator


def lane_pixels(
    n_lanes: int, tile_dim: Tuple[int, int], tile_offset
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Lane → (image_id, pixel_xy) mapping, matching the reference's
    tid % n_pixels layout (NaiveVolPTsk_kernel.cuh:22-27)."""
    tw, th = tile_dim
    lane = jnp.arange(n_lanes, dtype=jnp.uint32)
    image_id = lane % jnp.uint32(tw * th)
    px = (image_id % jnp.uint32(tw)).astype(jnp.float32) + tile_offset[0]
    py = jnp.floor(image_id.astype(jnp.float32) / tw) + tile_offset[1]
    return image_id.astype(jnp.int32), jnp.stack([px, py], axis=-1)


@partial(
    jax.jit,
    static_argnames=("settings", "tile_dim", "full_resolution", "spp"),
)
def render_tile(
    scene: Scene,
    camera: cam.Camera,
    settings: RenderSettings,
    tile_dim: Tuple[int, int],
    tile_offset: jnp.ndarray,  # (2,) float32 pixel offset of the tile
    full_resolution: Tuple[int, int],
    spp: int,
    seed,
    path_id_base,
):
    """Render spp samples for every pixel of a tile in one wavefront.

    Returns (accum, n_rays): accum is the (th, tw, 3) *sum* of radiance
    samples (progressive display divides by iterations, mirroring
    ImageBufferTransfer's Scale(1/iters), Utilities.h:6-15).

    path_id_base offsets the global path ids so successive progressive
    launches use fresh RNG streams (reference: seed_ += n_paths on reset,
    RenderKernelLauncher.cu:353-361).
    """
    tw, th = tile_dim
    n_lanes = tw * th * spp
    image_id, pixel_xy = lane_pixels(n_lanes, tile_dim, tile_offset)

    path_id = jnp.arange(n_lanes, dtype=jnp.uint32) + jnp.asarray(
        path_id_base, jnp.uint32
    )
    rng = make_rng(seed, path_id)

    o, d, rng = cam.generate_rays(camera, pixel_xy, full_resolution, rng)
    state = integrator.initial_state(o, d, rng)
    final = integrator.trace(scene, settings, state)

    accum = jnp.zeros((tw * th, 3), jnp.float32).at[image_id].add(
        final.radiance, mode="drop"
    )
    return accum.reshape(th, tw, 3), final.n_rays
