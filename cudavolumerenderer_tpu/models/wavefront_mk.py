"""Host-looped multi-kernel schedulers: naiveMK and streamingMK analogs.

The reference's MK family returns control to the host between bounces
(reference: NaiveVolPTmk launcher loop RenderKernelLauncher.cu:183-276 with
thrust stream compaction, and StreamingVolPTmk's regenerate/extend ping-pong
RenderKernelLauncher.cu:435-472).  Here the analog is a *Python-level*
loop of small jitted steps with a device→host sync on the active count each
bounce — exactly the dispatch overhead the thesis measures for these
strategies (naiveMK is its slowest kernel).  They are provided for parity
and as a scheduling-overhead baseline, not for speed.

naiveMK  : one jitted bounce per host step over a full path batch, with
           device-side compaction (sort by alive) between bounces.
streamingMK: host-looped regenerate → extend → compact super-iterations
           over the streaming SoA pool, with a device→host sync on the
           active count deciding loop exit — the reference's ping-pong
           buffer pair becomes the functional in/out state of one jitted
           super-iteration (render_tile_streaming_mk below).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops import camera as cam
from ..ops.rng import RngState, make_rng
from ..scene.types import RenderSettings, Scene
from . import integrator, naive, streaming


@partial(jax.jit, static_argnames=("settings",))
def _bounce_once(scene, settings, state):
    new_state = integrator.bounce_step(scene, settings, state)
    return new_state, jnp.sum(new_state.alive.astype(jnp.int32))


@partial(jax.jit, static_argnames=())
def _compact(state: integrator.PathState, image_id: jnp.ndarray):
    """Device-side stream compaction: stable-sort lanes by aliveness
    (the thrust::remove_if analog, RenderKernelLauncher.cu:266-275)."""
    order = jnp.argsort(jnp.logical_not(state.alive), stable=True)
    gather = lambda x: jnp.take(x, order, axis=0)
    return (
        integrator.PathState(
            o=gather(state.o),
            d=gather(state.d),
            throughput=gather(state.throughput),
            radiance=gather(state.radiance),
            alive=gather(state.alive),
            rng=jax.tree_util.tree_map(gather, state.rng),
            n_rays=state.n_rays,
        ),
        gather(image_id),
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
    compaction: bool = True,
):
    """naiveMK: host-controlled wavefront, one bounce per dispatch."""
    tw, th = tile_dim
    n_lanes = tw * th * spp
    image_id, pixel_xy = naive.lane_pixels(n_lanes, tile_dim, tile_offset)
    path_id = jnp.arange(n_lanes, dtype=jnp.uint32) + jnp.asarray(
        path_id_base, jnp.uint32
    )
    rng = make_rng(seed, path_id)
    o, d, rng = cam.generate_rays(camera, pixel_xy, full_resolution, rng)
    state = integrator.initial_state(o, d, rng)

    for _ in range(settings.max_path_length):
        state, n_active = _bounce_once(scene, settings, state)
        n_active = int(n_active)  # device→host sync, as in the reference
        if n_active == 0:
            break
        if compaction:
            state, image_id = _compact(state, image_id)

    accum = jnp.zeros((tw * th, 3), jnp.float32).at[image_id].add(
        state.radiance, mode="drop"
    )
    return accum.reshape(th, tw, 3), state.n_rays


# ---------------------------------------------------------------------------
# streamingMK: host-looped streaming wavefront with device-wide compaction
# ---------------------------------------------------------------------------

def _compact_stream(s: streaming.StreamState) -> streaming.StreamState:
    """Device-wide compaction of the streaming pool: survivors to the
    front, dead lanes as a contiguous tail (the cub ExclusiveSum scan +
    scatter of StreamingVolPTmk_kernel.cuh:218-253, expressed as one
    stable argsort permute — the out-buffer of the reference's ping-pong
    pair is this function's return value)."""
    order = jnp.argsort(jnp.logical_not(s.alive), stable=True)
    g = lambda x: jnp.take(x, order, axis=0)
    return streaming.StreamState(
        o=g(s.o), d=g(s.d), throughput=g(s.throughput),
        radiance=g(s.radiance), alive=g(s.alive), tracking=g(s.tracking),
        t=g(s.t), max_t=g(s.max_t), normal=g(s.normal),
        image_id=g(s.image_id),
        rng=RngState(state=g(s.rng.state), inc=g(s.rng.inc)),
        n_rays=s.n_rays,
        pending=g(s.pending), p_scat=g(s.p_scat),
    )


@partial(
    jax.jit,
    static_argnames=(
        "settings", "tile_dim", "full_resolution", "n_paths", "k_steps"
    ),
)
def _super_iteration(
    scene, camera, settings, tile_dim, tile_offset, full_resolution,
    n_paths, seed, path_id_base, s, paths_issued, accum, k_steps,
):
    """d_regenerate + d_extend + compaction as ONE dispatch (reference:
    the per-super-iteration launch pair, RenderKernelLauncher.cu:440-458).
    k_steps fused streaming steps per dispatch play the role of the
    extend kernel's inner bounce loop
    (StreamingVolPTmk_kernel.cuh:162-216)."""
    s, paths_issued = streaming._refill(
        s, paths_issued, n_paths, tile_dim, tile_offset,
        full_resolution, camera, seed, path_id_base,
    )
    for _ in range(k_steps):
        s, accum = streaming.extend_step(scene, settings, s, accum)
    s = _compact_stream(s)
    n_active = jnp.sum(s.alive.astype(jnp.int32))
    return s, paths_issued, accum, n_active


def render_tile_streaming_mk(
    scene: Scene,
    camera: cam.Camera,
    settings: RenderSettings,
    tile_dim: Tuple[int, int],
    tile_offset: jnp.ndarray,
    full_resolution: Tuple[int, int],
    spp: int,
    seed,
    path_id_base,
    n_lanes: int = 1 << 14,
    k_steps: int = 8,
):
    """streamingMK: the host drives regenerate/extend super-iterations
    over a fixed SoA pool and reads the active count back each dispatch
    (reference: the `while (n_active || queue)` host loop,
    RenderKernelLauncher.cu:435-472).  Same per-path RNG streams as
    streamingSK/naiveSK, so the estimate is identical lane-for-lane;
    only the dispatch structure differs.  Intentionally dispatch-bound —
    the thesis measures this family as the overhead baseline."""
    tw, th = tile_dim
    n_pix = tw * th
    n_paths = n_pix * spp
    n_lanes = min(n_lanes, n_paths)

    s = streaming.StreamState(
        o=jnp.zeros((n_lanes, 3), jnp.float32),
        d=jnp.broadcast_to(
            jnp.asarray([0.0, 0.0, 1.0], jnp.float32), (n_lanes, 3)
        ),
        throughput=jnp.ones((n_lanes, 3), jnp.float32),
        radiance=jnp.zeros((n_lanes, 3), jnp.float32),
        alive=jnp.zeros((n_lanes,), bool),
        tracking=jnp.zeros((n_lanes,), bool),
        t=jnp.zeros((n_lanes,), jnp.float32),
        max_t=jnp.zeros((n_lanes,), jnp.float32),
        normal=jnp.zeros((n_lanes, 3), jnp.float32),
        image_id=jnp.zeros((n_lanes,), jnp.int32),
        rng=make_rng(seed, jnp.zeros((n_lanes,), jnp.uint32)),
        n_rays=jnp.zeros((), jnp.float32),
        pending=jnp.zeros((n_lanes,), bool),
        p_scat=jnp.zeros((n_lanes, 3), jnp.float32),
    )
    accum = jnp.zeros((n_pix, 3), jnp.float32)
    paths_issued = jnp.int32(0)

    while True:
        s, paths_issued, accum, n_active = _super_iteration(
            scene, camera, settings, tile_dim, tile_offset,
            full_resolution, n_paths, seed, path_id_base,
            s, paths_issued, accum, k_steps,
        )
        # device→host sync each super-iteration, as in the reference
        if int(n_active) == 0 and int(paths_issued) >= n_paths:
            break

    return accum.reshape(th, tw, 3), s.n_rays
