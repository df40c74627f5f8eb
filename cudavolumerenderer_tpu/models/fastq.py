"""fastQ: queue-fed fast wavefront with deferred splat flush.

STATUS: design study, not the shipping path (PARITY.md §2.5) — wins
lane *utilization* (42%→69% on CPU) but lost wall-clock to fastSK's
cascade compaction when it was last measured; kept behind
`--kernel fastQ`.

Addresses the one weakness of fastSK's lane-pinned design: the straggler
tail (a lane serializes all samples of its pixel, so the slowest pixel
bounds the render; measured lane utilization ~33%).  fastQ restores the
reference's regeneration-queue load balancing (regenerationSK,
RegenerationVolPTsk_kernel.cuh) without paying a per-iteration image
scatter:

  * lanes pull path ids from a deterministic prefix-sum queue (any lane
    may run any path, so no lane idles while work remains);
  * a finished path's (pixel, radiance) moves to a per-lane *pending
    slot* and the lane immediately starts the next path;
  * pending slots are flushed to the image with one masked scatter-add
    every FLUSH_EVERY iterations (amortized ~scatter/8) — a lane only
    stalls in the rare case it finishes two paths within one flush
    window.

Tracking physics is identical to fastSK (fused 4-channel gather,
stochastic trilinear filtering, optional two-level sparse leap).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..constants import EPSILON
from ..ops import aabb, camera as cam, phase
from ..ops.rng import RngState, make_rng, next_float, next_uint32
from ..scene.types import RenderSettings, Scene
from . import integrator
from .fast import (
    BRICK,
    _stochastic_tap,
    brick_majorants,
    fused_row_decode,
    make_fused_grid,
)

FLUSH_EVERY = 8
REFILL_EVERY = 4


class QState(NamedTuple):
    o: jnp.ndarray
    d: jnp.ndarray
    throughput: jnp.ndarray
    radiance: jnp.ndarray  # (N, 3) current path accumulation
    image_id: jnp.ndarray  # (N,) current path's pixel
    pend_rad: jnp.ndarray  # (N, 3) finished path awaiting flush
    pend_pix: jnp.ndarray  # (N,) -1 when empty
    alive: jnp.ndarray
    tracking: jnp.ndarray
    t: jnp.ndarray
    max_t: jnp.ndarray
    normal: jnp.ndarray
    brick_exit: jnp.ndarray
    inv_sig_local: jnp.ndarray
    rng: RngState
    paths_issued: jnp.ndarray  # () int32
    accum: jnp.ndarray  # (n_pix, 3)
    n_rays: jnp.ndarray
    n_iters: jnp.ndarray
    n_busy: jnp.ndarray


@partial(
    jax.jit,
    static_argnames=(
        "settings", "tile_dim", "full_resolution", "spp", "n_lanes",
        "two_level", "with_stats",
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
    two_level: bool = False,
    with_stats: bool = False,
):
    tw, th = tile_dim
    n_pix = tw * th
    n_paths = n_pix * spp
    n_lanes = min(n_lanes, n_paths)
    med = scene.medium

    fused = make_fused_grid(scene)
    nz, ny, nx = med.density.data.shape
    res_minus_1 = jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.float32)
    extent = med.box_max - med.box_min
    scale = med.scale
    inv_sigmat = 1.0 / (scale * med.max_density)
    if two_level:
        bz_, by_, bx_ = BRICK
        nbz, nby, nbx = -(-nz // bz_), -(-ny // by_), -(-nx // bx_)
        bm_flat = brick_majorants(med.density.data).reshape(-1)
        brick_size = jnp.asarray([bx_, by_, bz_], jnp.float32)
        brick_hi = jnp.asarray([nbx - 1, nby - 1, nbz - 1], jnp.int32)

    zero3 = jnp.zeros((n_lanes, 3), jnp.float32)
    zero1 = jnp.zeros((n_lanes,), jnp.float32)
    state0 = QState(
        o=zero3, d=zero3.at[:, 2].set(1.0), throughput=jnp.ones_like(zero3),
        radiance=zero3,
        image_id=jnp.zeros((n_lanes,), jnp.int32),
        pend_rad=zero3,
        pend_pix=jnp.full((n_lanes,), -1, jnp.int32),
        alive=jnp.zeros((n_lanes,), bool),
        tracking=jnp.zeros((n_lanes,), bool),
        t=zero1, max_t=zero1, normal=zero3,
        brick_exit=zero1 - 1.0, inv_sig_local=zero1,
        rng=make_rng(seed, jnp.zeros((n_lanes,), jnp.uint32)),
        paths_issued=jnp.int32(0),
        accum=jnp.zeros((n_pix, 3), jnp.float32),
        n_rays=jnp.zeros((), jnp.float32),
        n_iters=jnp.zeros((), jnp.float32),
        n_busy=jnp.zeros((), jnp.float32),
    )

    def finish_path(alive, radiance, image_id, pend_rad, pend_pix, died):
        """Move finished paths' radiance into the pending slot (lanes with
        an occupied slot keep their result in `radiance` and stay dead
        until the next flush frees them)."""
        can_park = jnp.logical_and(died, pend_pix < 0)
        pend_rad = jnp.where(can_park[..., None], radiance, pend_rad)
        pend_pix = jnp.where(can_park, image_id, pend_pix)
        radiance = jnp.where(can_park[..., None], 0.0, radiance)
        # mark parked lanes as refillable by tagging image_id -1
        image_id = jnp.where(can_park, -1, image_id)
        return radiance, image_id, pend_rad, pend_pix

    def body(s: QState) -> QState:
        o, d, tput, rad = s.o, s.d, s.throughput, s.radiance
        image_id, alive, tracking, rng = (
            s.image_id, s.alive, s.tracking, s.rng
        )
        t, max_t, normal = s.t, s.max_t, s.normal
        brick_exit, inv_sig_local = s.brick_exit, s.inv_sig_local
        pend_rad, pend_pix = s.pend_rad, s.pend_pix
        accum, paths_issued = s.accum, s.paths_issued

        # ---- flush pending splats every FLUSH_EVERY iterations ----------
        do_flush = jnp.logical_or(
            jnp.mod(s.n_iters, FLUSH_EVERY) == FLUSH_EVERY - 1,
            paths_issued >= n_paths,  # drain at the end
        )

        def flush(args):
            accum_f, pend_rad_f, pend_pix_f = args
            accum_f = accum_f.at[jnp.maximum(pend_pix_f, 0)].add(
                jnp.where(pend_pix_f[..., None] >= 0, pend_rad_f, 0.0),
                mode="drop",
            )
            return accum_f, jnp.zeros_like(pend_rad_f), jnp.full_like(
                pend_pix_f, -1
            )

        accum, pend_rad, pend_pix = jax.lax.cond(
            do_flush,
            flush,
            lambda args: args,
            (accum, pend_rad, pend_pix),
        )

        # ---- regenerate from the deterministic queue --------------------
        # Batched every REFILL_EVERY iterations (the cumsum allocator is
        # ~as expensive as the density gather, so it must amortize); a
        # freshly-dead lane idles at most REFILL_EVERY-1 iterations.
        do_refill = jnp.mod(s.n_iters, REFILL_EVERY) == 0

        def refill(args):
            o, d, tput, rad, image_id, alive, tracking, rng, paths_issued = (
                args
            )
            refillable = jnp.logical_and(
                jnp.logical_not(alive), pend_pix < 0
            )
            rank = jnp.cumsum(refillable.astype(jnp.int32)) - 1
            new_id = paths_issued + rank
            takes = jnp.logical_and(refillable, new_id < n_paths)
            paths_issued = paths_issued + jnp.sum(takes.astype(jnp.int32))
            pid = jnp.where(takes, new_id, 0).astype(jnp.uint32)
            image_id_new = (pid % jnp.uint32(n_pix)).astype(jnp.int32)
            px = (image_id_new % tw).astype(jnp.float32) + tile_offset[0]
            py = (
                jnp.floor(image_id_new.astype(jnp.float32) / tw)
                + tile_offset[1]
            )
            pixel_xy = jnp.stack([px, py], axis=-1)
            fresh = make_rng(
                seed, pid + jnp.asarray(path_id_base, jnp.uint32)
            )
            rng = RngState(
                state=jnp.where(takes, fresh.state, rng.state),
                inc=jnp.where(takes, fresh.inc, rng.inc),
            )
            o_new, d_new, rng = cam.generate_rays(
                camera, pixel_xy, full_resolution, rng, active=takes
            )
            mm = takes[..., None]
            o = jnp.where(mm, o_new, o)
            d = jnp.where(mm, d_new, d)
            tput = jnp.where(mm, 1.0, tput)
            rad = jnp.where(mm, 0.0, rad)
            image_id = jnp.where(takes, image_id_new, image_id)
            alive = jnp.logical_or(alive, takes)
            tracking = jnp.where(takes, False, tracking)
            return (
                o, d, tput, rad, image_id, alive, tracking, rng,
                paths_issued,
            )

        (o, d, tput, rad, image_id, alive, tracking, rng, paths_issued) = (
            jax.lax.cond(
                do_refill,
                refill,
                lambda args: args,
                (o, d, tput, rad, image_id, alive, tracking, rng,
                 paths_issued),
            )
        )
        alive_after_regen = alive

        # ---- segment start ------------------------------------------------
        need_isect = jnp.logical_and(alive, jnp.logical_not(tracking))
        n_rays = s.n_rays + jnp.sum(need_isect.astype(jnp.float32))
        isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
        miss = jnp.logical_and(need_isect, jnp.logical_not(isect.hit))
        rad = jnp.where(miss[..., None], rad + tput * scene.le, rad)
        alive = jnp.logical_and(alive, jnp.logical_not(miss))

        enters = jnp.logical_and(
            need_isect, jnp.logical_and(isect.hit, isect.inside_volume)
        )
        boundary_now = jnp.logical_and(
            need_isect,
            jnp.logical_and(isect.hit, jnp.logical_not(isect.inside_volume)),
        )
        tracking = jnp.logical_or(tracking, enters)
        t = jnp.where(enters, 0.0, t)
        max_t = jnp.where(enters, isect.dist, max_t)
        normal = jnp.where(need_isect[..., None], isect.normal, normal)
        brick_exit = jnp.where(enters, -1.0, brick_exit)

        # ---- one tracking step (same physics as fastSK) -------------------
        step_mask = tracking
        if two_level:
            epsw = jnp.max(extent) * 1e-6
            need_brick = jnp.logical_and(step_mask, t >= brick_exit)
            p_now = o + (t + epsw)[..., None] * d
            coordn = (
                jnp.clip((p_now - med.box_min) / extent, 0.0, 1.0)
                * res_minus_1
            )
            bi = jnp.clip(
                jnp.floor(coordn / brick_size).astype(jnp.int32), 0, brick_hi
            )
            bflat = (bi[..., 2] * nby + bi[..., 1]) * nbx + bi[..., 0]
            rho_b = jnp.take(bm_flat, bflat, axis=0)
            up = (d > 0.0).astype(jnp.float32)
            bound_coord = (bi.astype(jnp.float32) + up) * brick_size
            bound_world = med.box_min + extent * bound_coord / res_minus_1
            okd = jnp.abs(d) > 1e-12
            t_axes = jnp.where(
                okd, (bound_world - o) / jnp.where(okd, d, 1.0), jnp.inf
            )
            exit_new = jnp.maximum(jnp.min(t_axes, axis=-1), t + epsw)
            brick_exit = jnp.where(need_brick, exit_new, brick_exit)
            inv_new = jnp.where(
                rho_b > 0.0,
                1.0 / (scale * jnp.maximum(rho_b, 1e-30)),
                jnp.inf,
            )
            inv_sig_local = jnp.where(need_brick, inv_new, inv_sig_local)
            empty = jnp.logical_and(
                step_mask, jnp.logical_not(jnp.isfinite(inv_sig_local))
            )
            stepping = jnp.logical_and(step_mask, jnp.logical_not(empty))
            u1, rng = next_float(rng, stepping)
            step = jnp.where(
                stepping,
                -jnp.log(jnp.maximum(u1, EPSILON)) * inv_sig_local,
                0.0,
            )
            t_cand = jnp.where(empty, brick_exit, t + step)
            eff_exit = jnp.minimum(brick_exit, max_t)
            crossed = jnp.logical_and(step_mask, t_cand >= eff_exit)
            overran = jnp.logical_and(crossed, max_t <= brick_exit)
            transit = jnp.logical_and(crossed, jnp.logical_not(overran))
            inside = jnp.logical_and(stepping, jnp.logical_not(crossed))
            t_new = jnp.where(
                transit, brick_exit, jnp.where(step_mask, t_cand, t)
            )
        else:
            u1, rng = next_float(rng, step_mask)
            step = -jnp.log(jnp.maximum(u1, EPSILON)) * inv_sigmat
            t_new = jnp.where(step_mask, t + step, t)
            overran = jnp.logical_and(step_mask, t_new > max_t)
            inside = jnp.logical_and(step_mask, jnp.logical_not(overran))

        p = o + t_new[..., None] * d
        coord = jnp.clip((p - med.box_min) / extent, 0.0, 1.0) * res_minus_1
        tap_bits, rng = next_uint32(rng, inside)
        tap = _stochastic_tap(coord, tap_bits)
        ix = jnp.clip(tap[..., 0], 0, nx - 1)
        iy = jnp.clip(tap[..., 1], 0, ny - 1)
        iz = jnp.clip(tap[..., 2], 0, nz - 1)
        row = jnp.take(fused, (iz * ny + iy) * nx + ix, axis=0)
        rho_hat, alb_hat = fused_row_decode(scene, row)
        u2, rng = next_float(rng, inside)
        if two_level:
            accepted = jnp.logical_and(
                inside,
                jnp.logical_not(scale * rho_hat * inv_sig_local < u2),
            )
        else:
            accepted = jnp.logical_and(
                inside,
                jnp.logical_not(scale * rho_hat * inv_sigmat < u2),
            )
        terminated = jnp.logical_or(overran, accepted)
        scattered = accepted
        t = t_new
        tracking = jnp.logical_and(tracking, jnp.logical_not(terminated))

        # ---- boundary event ----------------------------------------------
        boundary = jnp.logical_or(boundary_now, overran)
        o_bound = jnp.where(
            boundary_now[..., None],
            o + d * isect.dist[..., None],
            o + d * max_t[..., None],
        )
        o_b, d_b, t_b, rng = integrator.boundary_event(
            scene, settings, normal, o_bound, d, tput, rng, boundary
        )

        # ---- scatter event ------------------------------------------------
        o_s = o + d * t[..., None] - d * EPSILON
        d_s, rng = phase.sample_phase(d, med.g, rng, active=scattered)

        o = jnp.where(
            scattered[..., None], o_s,
            jnp.where(boundary[..., None], o_b, o),
        )
        d = jnp.where(
            scattered[..., None], d_s,
            jnp.where(boundary[..., None], d_b, d),
        )
        tput = jnp.where(
            scattered[..., None], tput * alb_hat,
            jnp.where(boundary[..., None], t_b, tput),
        )

        # ---- Russian roulette --------------------------------------------
        had_event = jnp.logical_and(
            alive, jnp.logical_or(scattered, boundary)
        )
        if settings.russian_roulette:
            tput, alive, _, rng = integrator.russian_roulette(
                tput, alive, rng, had_event
            )

        died = jnp.logical_and(
            alive_after_regen, jnp.logical_not(alive)
        )
        rad, image_id, pend_rad, pend_pix = finish_path(
            alive, rad, image_id, pend_rad, pend_pix, died
        )

        return QState(
            o=o, d=d, throughput=tput, radiance=rad, image_id=image_id,
            pend_rad=pend_rad, pend_pix=pend_pix, alive=alive,
            tracking=tracking, t=t, max_t=max_t, normal=normal,
            brick_exit=brick_exit, inv_sig_local=inv_sig_local, rng=rng,
            paths_issued=paths_issued, accum=accum, n_rays=n_rays,
            n_iters=s.n_iters + 1.0,
            n_busy=s.n_busy + jnp.sum(tracking.astype(jnp.float32)),
        )

    def cond_fn(s: QState):
        return jnp.logical_or(
            jnp.any(jnp.logical_or(s.alive, s.pend_pix >= 0)),
            s.paths_issued < n_paths,
        )

    final = jax.lax.while_loop(cond_fn, body, state0)
    # final drain of any remaining pending slots
    accum = final.accum.at[jnp.maximum(final.pend_pix, 0)].add(
        jnp.where(final.pend_pix[..., None] >= 0, final.pend_rad, 0.0),
        mode="drop",
    )
    img = accum.reshape(th, tw, 3)
    if with_stats:
        return img, final.n_rays, final.n_iters, final.n_busy
    return img, final.n_rays
