"""Streaming scheduler: fully-fused single-step wavefront state machine.

Wavefront analog of streamingSK (reference:
implementation/src/StreamingVolPTsk_kernel.cuh:27-360): the reference keeps
a block-resident SoA ray slab and alternates regenerate → extend → compact
super-iterations.  Here the same idea becomes one flat `lax.while_loop`
in which *every* iteration does a constant amount of uniform work per lane:

  1. dead lanes are refilled from the deterministic path queue
     (prefix-sum allocation — the atomic-free work queue);
  2. lanes between segments run the AABB test and classify their event;
  3. tracking lanes take exactly one Woodcock step (one density gather);
  4. lanes whose segment terminated run their scatter/boundary event and
     Russian roulette.

Unlike the naive scheduler there is no nested tracking loop: a lane that
finishes its free flight immediately proceeds to its event and next
segment while neighbors keep stepping — the lockstep-SIMD equivalent of
persistent threads never idling.  Compaction is unnecessary because lanes
are refilled in place; the reference's cub scan/scatter compaction exists
to keep *warps* converged, which masking already guarantees here
(SURVEY.md §2.8: the atomic work queue must become prefix-sum allocation).

Per-lane RNG draw order is identical to the naive scheduler, so both
produce the *same estimate* for the same (seed, path id) — the basis of
the scheduler-agreement tests.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..constants import EPSILON
from ..ops import aabb, camera as cam, morton, phase, woodcock
from ..ops.rng import RngState, make_rng
from ..scene.types import RenderSettings, Scene
from . import integrator


class StreamState(NamedTuple):
    o: jnp.ndarray  # (N, 3)
    d: jnp.ndarray  # (N, 3)
    throughput: jnp.ndarray  # (N, 3)
    radiance: jnp.ndarray  # (N, 3)
    alive: jnp.ndarray  # (N,)
    tracking: jnp.ndarray  # (N,) mid-free-flight
    t: jnp.ndarray  # (N,) current tracking distance
    max_t: jnp.ndarray  # (N,) boundary distance for this segment
    normal: jnp.ndarray  # (N, 3) cached boundary normal for this segment
    image_id: jnp.ndarray  # (N,) int32
    rng: RngState
    n_rays: jnp.ndarray  # ()
    # sortingSK deferred texture access: lanes that scattered but have not
    # yet fetched their albedo (reference: temp_storage.texture_access,
    # SortingVolPTsk_kernel.cuh:232-241); p_scat is the saved fetch point
    pending: jnp.ndarray  # (N,) bool
    p_scat: jnp.ndarray  # (N, 3)


def _refill(
    s: StreamState,
    paths_issued,
    n_paths: int,
    tile_dim,
    tile_offset,
    full_resolution,
    camera,
    seed,
    path_id_base,
):
    tw, th = tile_dim
    n_pix = tw * th
    dead = jnp.logical_not(s.alive)
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
        state=jnp.where(takes, fresh.state, s.rng.state),
        inc=jnp.where(takes, fresh.inc, s.rng.inc),
    )
    o_new, d_new, rng = cam.generate_rays(
        camera, pixel_xy, full_resolution, rng, active=takes
    )
    m = takes[..., None]
    return (
        s._replace(
            o=jnp.where(m, o_new, s.o),
            d=jnp.where(m, d_new, s.d),
            throughput=jnp.where(m, 1.0, s.throughput),
            radiance=jnp.where(m, 0.0, s.radiance),
            alive=jnp.logical_or(s.alive, takes),
            tracking=jnp.where(takes, False, s.tracking),
            rng=rng,
            image_id=jnp.where(takes, image_id_new, s.image_id),
        ),
        paths_issued + n_taken,
    )


def _morton_reorder(s: StreamState, box_min, box_max) -> StreamState:
    """Permute the lane pool into Morton order of current positions — the
    sortingSK re-expression (reference: SortingVolPTsk_kernel.cuh:149-176,
    MortonSort.h:12-68).  Dead lanes sort to the tail, which doubles as
    compaction: regeneration refills a contiguous suffix."""
    keys = morton.ray_sort_keys(s.o, box_min, box_max, s.alive)
    order = jnp.argsort(keys)
    g = lambda x: jnp.take(x, order, axis=0)
    return StreamState(
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
        "settings", "tile_dim", "full_resolution", "spp", "n_lanes",
        "sort_every", "defer_access",
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
    sort_every: int = 0,
    defer_access: bool = False,
):
    if defer_access and sort_every <= 0:
        raise ValueError("defer_access requires sort_every > 0")
    tw, th = tile_dim
    n_pix = tw * th
    n_paths = n_pix * spp
    n_lanes = min(n_lanes, n_paths)
    med = scene.medium

    state0 = StreamState(
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
    accum0 = jnp.zeros((n_pix, 3), jnp.float32)

    def cond(carry):
        s, paths_issued, _, _ = carry
        return jnp.logical_or(jnp.any(s.alive), paths_issued < n_paths)

    def body(carry):
        s, paths_issued, accum, it = carry
        if sort_every > 0:
            s = jax.lax.cond(
                it % sort_every == 0,
                lambda st: _morton_reorder(st, med.box_min, med.box_max),
                lambda st: st,
                s,
            )
            if defer_access:
                # coherent deferred fetches right after the sort
                s, accum = jax.lax.cond(
                    it % sort_every == 0,
                    lambda sa: flush_pending(scene, settings, *sa),
                    lambda sa: sa,
                    (s, accum),
                )
        s, paths_issued = _refill(
            s, paths_issued, n_paths, tile_dim, tile_offset,
            full_resolution, camera, seed, path_id_base,
        )
        s, accum = extend_step(
            scene, settings, s, accum, defer_albedo=defer_access
        )
        return s, paths_issued, accum, it + 1

    final, _, accum, _ = jax.lax.while_loop(
        cond, body, (state0, jnp.int32(0), accum0, jnp.int32(0))
    )
    return accum.reshape(th, tw, 3), final.n_rays


def extend_step(
    scene: Scene, settings: RenderSettings, s: StreamState,
    accum: jnp.ndarray, defer_albedo: bool = False,
):
    """One fused streaming step (phases 2-4 + Russian roulette) for every
    lane: AABB/classify, one Woodcock step, event handling, and a masked
    splat of finished paths into `accum`.  This is the shared 'extend'
    body of streamingSK (while_loop-resident) and streamingMK
    (host-dispatched; reference: StreamingVolPTmk_kernel.cuh:72-254).

    defer_albedo=True is sortingSK's defining mechanic: a lane that
    scatters records the fetch point and *stalls* instead of gathering
    its albedo; flush_pending performs all outstanding fetches as one
    spatially-coherent batched gather right after the Morton sort
    (reference: SortingVolPTsk_kernel.cuh:105-147,232-241).  Per-path
    draw order is unchanged (the RR draw moves with the fetch, still
    after the phase draw in the path's own stream), so estimates are
    identical lane-for-lane."""
    med = scene.medium

    was_alive = s.alive

    # --- phase 2: segment start — AABB test + event classification ---
    # pending lanes are stalled: they neither start a segment nor step
    need_isect = jnp.logical_and(s.alive, jnp.logical_not(s.tracking))
    if defer_albedo:
        need_isect = jnp.logical_and(
            need_isect, jnp.logical_not(s.pending)
        )
    s = s._replace(
        n_rays=s.n_rays + jnp.sum(need_isect.astype(jnp.float32))
    )
    isect = aabb.aabb_intersect(med.box_min, med.box_max, s.o, s.d)

    miss = jnp.logical_and(need_isect, jnp.logical_not(isect.hit))
    radiance = jnp.where(
        miss[..., None],
        s.radiance + s.throughput * scene.le,
        s.radiance,
    )
    alive = jnp.logical_and(
        s.alive, jnp.logical_not(miss)
    )

    enters_medium = jnp.logical_and(
        need_isect, jnp.logical_and(isect.hit, isect.inside_volume)
    )
    boundary_now = jnp.logical_and(
        need_isect,
        jnp.logical_and(isect.hit, jnp.logical_not(isect.inside_volume)),
    )
    tracking = jnp.logical_or(s.tracking, enters_medium)
    t = jnp.where(enters_medium, 0.0, s.t)
    max_t = jnp.where(enters_medium, isect.dist, s.max_t)
    normal = jnp.where(
        need_isect[..., None], isect.normal, s.normal
    )

    # --- phase 3: one Woodcock step for tracking lanes ----------------
    step_mask = jnp.logical_and(
        tracking, jnp.logical_not(enters_medium)
    )  # fresh segments start stepping next iteration
    t_new, terminated, scattered, rng = woodcock.woodcock_step_masked(
        med.density, med.box_min, med.box_max, med.scale,
        med.max_density, s.o, s.d, t, max_t, s.rng, step_mask,
        settings.interpolation,
    )
    t = t_new
    tracking = jnp.logical_and(tracking, jnp.logical_not(terminated))
    overran = jnp.logical_and(terminated, jnp.logical_not(scattered))

    # --- phase 4a: boundary event (fresh outside-hit or overrun) ------
    boundary = jnp.logical_or(boundary_now, overran)
    o_bound = s.o + s.d * max_t[..., None]
    o_bound = jnp.where(
        boundary_now[..., None],
        s.o + s.d * isect.dist[..., None],
        o_bound,
    )
    o_b_out, d_b_out, t_b_out, rng = integrator.boundary_event(
        scene, settings, normal, o_bound, s.d, s.throughput, rng,
        boundary,
    )

    # --- phase 4b: medium scatter event -------------------------------
    o_scat = s.o + s.d * t[..., None] - s.d * EPSILON
    if not defer_albedo:
        albedo = integrator.sample_albedo(scene, o_scat, settings)
    d_scat, rng = phase.sample_phase(
        s.d, med.g, RngState(rng.state, rng.inc), active=scattered
    )

    o = jnp.where(
        scattered[..., None],
        o_scat,
        jnp.where(boundary[..., None], o_b_out, s.o),
    )
    d = jnp.where(
        scattered[..., None],
        d_scat,
        jnp.where(boundary[..., None], d_b_out, s.d),
    )
    if defer_albedo:
        # record the fetch, stall the lane; throughput multiplied (and
        # RR run) at flush_pending after the next Morton sort
        throughput = jnp.where(
            boundary[..., None], t_b_out, s.throughput
        )
        pending = jnp.logical_or(s.pending, scattered)
        p_scat = jnp.where(scattered[..., None], o_scat, s.p_scat)
    else:
        throughput = jnp.where(
            scattered[..., None],
            s.throughput * albedo,
            jnp.where(boundary[..., None], t_b_out, s.throughput),
        )
        pending, p_scat = s.pending, s.p_scat

    # --- Russian roulette after any event ------------------------------
    had_event = jnp.logical_and(
        alive, jnp.logical_or(scattered, boundary)
    )
    if defer_albedo:
        # scatter-event RR moves to flush_pending (after the fetch)
        had_event = jnp.logical_and(
            had_event, jnp.logical_not(scattered)
        )
    if settings.russian_roulette:
        throughput, alive, _, rng = integrator.russian_roulette(
            throughput, alive, rng, had_event
        )

    died = jnp.logical_and(was_alive, jnp.logical_not(alive))
    accum = accum.at[s.image_id].add(
        jnp.where(died[..., None], radiance, 0.0), mode="drop"
    )
    radiance = jnp.where(died[..., None], 0.0, radiance)

    s = s._replace(
        o=o, d=d, throughput=throughput, radiance=radiance,
        alive=alive, tracking=tracking, t=t, max_t=max_t,
        normal=normal, rng=rng, pending=pending, p_scat=p_scat,
    )
    return s, accum


def flush_pending(
    scene: Scene, settings: RenderSettings, s: StreamState,
    accum: jnp.ndarray,
):
    """Perform all deferred albedo fetches as one coherent batched gather
    (reference: swapThreadAndAccessTexture,
    SortingVolPTsk_kernel.cuh:105-147), apply the deferred throughput
    multiply, and run the deferred scatter-event Russian roulette."""
    was_alive = s.alive
    albedo = integrator.sample_albedo(scene, s.p_scat, settings)
    throughput = jnp.where(
        s.pending[..., None], s.throughput * albedo, s.throughput
    )
    alive, rng = s.alive, s.rng
    if settings.russian_roulette:
        throughput, alive, _, rng = integrator.russian_roulette(
            throughput, alive, rng, s.pending
        )
        died = jnp.logical_and(was_alive, jnp.logical_not(alive))
        accum = accum.at[s.image_id].add(
            jnp.where(died[..., None], s.radiance, 0.0), mode="drop"
        )
        s = s._replace(
            radiance=jnp.where(died[..., None], 0.0, s.radiance)
        )
    return (
        s._replace(
            throughput=throughput, alive=alive, rng=rng,
            pending=jnp.zeros_like(s.pending),
        ),
        accum,
    )
