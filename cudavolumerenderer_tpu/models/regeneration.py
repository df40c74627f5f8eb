"""Regeneration scheduler: persistent wavefront + deterministic work queue.

Wavefront analog of regenerationSK, the reference's default and usually fastest
strategy (reference: implementation/src/RegenerationVolPTsk_kernel.cuh:147-232
and its launcher RenderKernelLauncher.cu:281-351): a fixed-size pool of
lanes runs bounce after bounce; whenever a lane's path dies it immediately
pulls a fresh path id from the work queue.  The reference's global
`atomicAdd(&paths_head_global, 1)` allocator becomes a *deterministic
prefix-sum allocation* over the dead-lane mask — same load balancing, no
atomics, bitwise-reproducible across shardings (SURVEY.md §7 stage 5).

Dead lanes splat their finished radiance into the tile accumulator via a
masked scatter-add (the reference's atomicVectorAdd, Utilities.cuh:15-22).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops import camera as cam
from ..ops.rng import RngState, make_rng
from ..scene.types import RenderSettings, Scene
from . import integrator


def _regenerate(
    carry_state: integrator.PathState,
    image_id: jnp.ndarray,
    paths_issued: jnp.ndarray,
    n_paths: int,
    tile_dim: Tuple[int, int],
    tile_offset: jnp.ndarray,
    full_resolution: Tuple[int, int],
    camera: cam.Camera,
    seed,
    path_id_base,
    refill_group: int = 1,
):
    """Refill dead lanes with fresh paths from the deterministic queue.

    refill_group re-expresses the reference's regeneration granularity
    axis (REGENERATION_SYNCHRONIZATION_LEVEL 0/1/2: per-thread, per-warp
    via __shfl_sync broadcast, per-block via shared counters —
    RegenerationVolPTsk_kernel.cuh:22-141,238-352): a group of
    `refill_group` consecutive lanes refills only once EVERY lane in the
    group is dead, and then refills together.  1 = thread-level (each
    lane independently), 8 = a small lane group, the analog of a warp,
    1024 = the lane-row analog of a block.  The estimator is unchanged
    (streams stay keyed by (seed, path_id)); only queue-pull cadence and
    lane idle time differ — thesis Tables 4.3/4.4 measure this axis.
    """
    tw, th = tile_dim
    n_pix = tw * th
    dead = jnp.logical_not(carry_state.alive)
    if refill_group > 1:
        g = refill_group
        n = dead.shape[0]
        # groups wait for their whole membership to die before pulling
        # new work (lanes past a non-multiple tail refill individually)
        n_full = (n // g) * g
        if n_full > 0:
            dead_g = jnp.all(dead[:n_full].reshape(-1, g), axis=1)
            dead = jnp.concatenate(
                [jnp.repeat(dead_g, g), dead[n_full:]]
            )
    # Prefix-sum allocation: k-th dead lane gets id paths_issued + k.
    rank = jnp.cumsum(dead.astype(jnp.int32)) - 1
    new_id = paths_issued + rank
    takes = jnp.logical_and(dead, new_id < n_paths)
    n_taken = jnp.sum(takes.astype(jnp.int32))

    pid = jnp.where(takes, new_id, 0).astype(jnp.uint32)
    image_id_new = (pid % jnp.uint32(n_pix)).astype(jnp.int32)
    px = (image_id_new % tw).astype(jnp.float32) + tile_offset[0]
    py = jnp.floor(image_id_new.astype(jnp.float32) / tw) + tile_offset[1]
    pixel_xy = jnp.stack([px, py], axis=-1)

    fresh = make_rng(seed, pid + jnp.asarray(path_id_base, jnp.uint32))
    rng = RngState(
        state=jnp.where(takes, fresh.state, carry_state.rng.state),
        inc=jnp.where(takes, fresh.inc, carry_state.rng.inc),
    )
    o_new, d_new, rng = cam.generate_rays(
        camera, pixel_xy, full_resolution, rng, active=takes
    )

    m = takes[..., None]
    state = integrator.PathState(
        o=jnp.where(m, o_new, carry_state.o),
        d=jnp.where(m, d_new, carry_state.d),
        throughput=jnp.where(m, 1.0, carry_state.throughput),
        radiance=jnp.where(m, 0.0, carry_state.radiance),
        alive=jnp.logical_or(carry_state.alive, takes),
        rng=rng,
        n_rays=carry_state.n_rays,
    )
    image_id = jnp.where(takes, image_id_new, image_id)
    return state, image_id, paths_issued + n_taken


@partial(
    jax.jit,
    static_argnames=(
        "settings", "tile_dim", "full_resolution", "spp", "n_lanes",
        "refill_group",
    ),
)
def render_tile(
    scene: Scene,
    camera: cam.Camera,
    settings: RenderSettings,
    tile_dim: Tuple[int, int],
    tile_offset: jnp.ndarray,
    full_resolution: Tuple[int, int],
    spp: int,
    seed,
    path_id_base,
    n_lanes: int = 1 << 16,
    refill_group: int = 1,
):
    """Render a tile with a fixed lane pool regenerated from a path queue.

    n_paths = tile pixels × spp (reference: setNIterations,
    RenderKernelLauncher.cu:122-127); the pool size n_lanes plays the role
    of the persistent-thread grid size.
    """
    tw, th = tile_dim
    n_pix = tw * th
    n_paths = n_pix * spp
    n_lanes = min(n_lanes, n_paths)

    accum0 = jnp.zeros((n_pix, 3), jnp.float32)
    # Start with an all-dead pool; the first loop iteration fills it.
    dummy_rng = make_rng(seed, jnp.zeros((n_lanes,), jnp.uint32))
    state0 = integrator.PathState(
        o=jnp.zeros((n_lanes, 3), jnp.float32),
        d=jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (n_lanes, 3)
        ),
        throughput=jnp.ones((n_lanes, 3), jnp.float32),
        radiance=jnp.zeros((n_lanes, 3), jnp.float32),
        alive=jnp.zeros((n_lanes,), bool),
        rng=dummy_rng,
        n_rays=jnp.zeros((), jnp.float32),
    )
    image_id0 = jnp.zeros((n_lanes,), jnp.int32)

    def cond(carry):
        state, _, paths_issued, _ = carry
        return jnp.logical_or(
            jnp.any(state.alive), paths_issued < n_paths
        )

    def body(carry):
        state, image_id, paths_issued, accum = carry
        state, image_id, paths_issued = _regenerate(
            state, image_id, paths_issued, n_paths, tile_dim, tile_offset,
            full_resolution, camera, seed, path_id_base,
            refill_group=refill_group,
        )
        was_alive = state.alive
        state = integrator.bounce_step(scene, settings, state)
        died = jnp.logical_and(was_alive, jnp.logical_not(state.alive))
        accum = accum.at[image_id].add(
            jnp.where(died[..., None], state.radiance, 0.0), mode="drop"
        )
        state = state._replace(
            radiance=jnp.where(died[..., None], 0.0, state.radiance)
        )
        return state, image_id, paths_issued, accum

    final_state, _, _, accum = jax.lax.while_loop(
        cond, body, (state0, image_id0, jnp.int32(0), accum0)
    )
    return accum.reshape(th, tw, 3), final_state.n_rays
