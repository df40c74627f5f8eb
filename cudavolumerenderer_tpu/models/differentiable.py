"""Differentiable rendering: gradients of pixel radiance w.r.t. the voxel
density and albedo grids through the stochastic transmittance estimator.

New capability over the reference (per BASELINE.json), designed
as *path-replay backprop* with a score-function density estimator:

  forward:   render as usual (any scheduler); save nothing but the seed.
  backward:  replay every path with the identical counter-based RNG
             streams (deterministic by construction, ops/rng.py) —
             pass A recomputes each lane's final contribution C;
             pass B replays again, scatter-adding adjoints:
               albedo (reparameterized, exact):
                   dL/d albedo_c(tap) += g_c[pixel] * C_c / albedo_c(x)
                       * trilerp_weight(tap)
                 at every scatter event;
               density (score function, unbiased):
                   real collision at x:  s * 1/rho(x)
                   null collision at x:  s * -1/(rho_max - rho(x))
                 with s = sum_c g_c[pixel] * C_c, scattered to the 8
                 trilinear taps of every Woodcock density evaluation.

  This stores O(1) per path (recompute instead of record — the
  jax.checkpoint philosophy applied to a stochastic estimator), and every
  adjoint is a segment-sum-style scatter-add (which XLA lowers to
  atomic adds on the GPU, as the reference would accumulate gradients).

Sampling decisions are treated as fixed under differentiation
(stop-gradient free flight); Russian roulette decisions are likewise
detached — gradcheck configs disable RR (settings.russian_roulette=False)
to make finite differences exact in expectation.

The score-function derivation (null-collision process):
  p(path) ∝ prod_null (1 - rho(x_i)/rho_max) * prod_real (rho(x_j)/rho_max)
  d log p / d rho(x_i)|null = -1/(rho_max - rho(x_i))
  d log p / d rho(x_j)|real = +1/rho(x_j)
with the majorant rho_max held constant.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..constants import EPSILON
from ..ops import aabb, camera as cam, ggx, math3, phase
from ..ops.grid import Grid, sample
from ..ops.rng import RngState, make_rng, next_float, next_uint32
from ..scene.types import Bsdf, Medium, RenderSettings, Scene
from . import fast, integrator, naive


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Hashable non-grid scene parameters (custom_vjp static args)."""

    box_min: Tuple[float, float, float] = (-0.5, -0.5, -0.5)
    box_max: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    scale: float = 1.0
    max_density: float = 1.0
    g: float = 0.0
    roughness: Tuple[float, float] = (0.1, 0.1)
    eta: float = 1.05 / 1.01
    le: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    @classmethod
    def from_scene(cls, scene: Scene) -> "SceneSpec":
        med = scene.medium
        return cls(
            box_min=tuple(float(v) for v in med.box_min),
            box_max=tuple(float(v) for v in med.box_max),
            scale=float(med.scale),
            max_density=float(med.max_density),
            g=float(med.g),
            roughness=tuple(float(v) for v in scene.bsdf.roughness),
            eta=float(scene.bsdf.eta),
            le=tuple(float(v) for v in scene.le),
        )

    def build(self, density_data, albedo_data) -> Scene:
        return Scene(
            medium=Medium(
                density=Grid(data=density_data),
                albedo=Grid(data=albedo_data),
                box_min=jnp.asarray(self.box_min, jnp.float32),
                box_max=jnp.asarray(self.box_max, jnp.float32),
                scale=jnp.asarray(self.scale, jnp.float32),
                max_density=jnp.asarray(self.max_density, jnp.float32),
                g=jnp.asarray(self.g, jnp.float32),
            ),
            bsdf=Bsdf(
                roughness=jnp.asarray(self.roughness, jnp.float32),
                eta=jnp.asarray(self.eta, jnp.float32),
            ),
            le=jnp.asarray(self.le, jnp.float32),
        )


@dataclasses.dataclass(frozen=True)
class CameraSpec:
    """Hashable camera parameters (custom_vjp static args)."""

    res_x: int = 400
    res_y: int = 400
    fov_x_deg: float = 0.7
    position: Tuple[float, float, float] = (0.0, 0.0, 100.0)
    mitsuba_comparable: bool = True
    #: optional look-at pose for multi-view inverse rendering; when set,
    #: the camera orients from `position` toward `look_at` (reference:
    #: Camera.h lookAt:107-122) instead of the default -z axis pose
    look_at: Optional[Tuple[float, float, float]] = None
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)

    def build(self) -> cam.Camera:
        if self.look_at is not None:
            return cam.make_camera_look_at(
                self.position, self.look_at, self.up,
                self.res_x, self.res_y, self.fov_x_deg,
            )
        return cam.make_camera(
            self.res_x, self.res_y, self.fov_x_deg, self.position,
            self.mitsuba_comparable,
        )


def _trilerp_taps(grid_shape_zyx, box_min, box_max, p_world):
    """Flat tap indices + lerp weights for scatter-adding adjoints at the
    same 8 taps the forward trilinear sampler reads (ops/grid.py)."""
    nz, ny, nx = grid_shape_zyx[:3]
    p01 = (p_world - box_min) / (box_max - box_min)
    coord = p01 * jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.float32)
    c0 = jnp.floor(coord)
    i0 = c0.astype(jnp.int32)
    f = coord - c0
    taps = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                ix = jnp.clip(i0[..., 0] + dx, 0, nx - 1)
                iy = jnp.clip(i0[..., 1] + dy, 0, ny - 1)
                iz = jnp.clip(i0[..., 2] + dz, 0, nz - 1)
                w = (
                    (f[..., 0] if dx else 1.0 - f[..., 0])
                    * (f[..., 1] if dy else 1.0 - f[..., 1])
                    * (f[..., 2] if dz else 1.0 - f[..., 2])
                )
                taps.append(((iz * ny + iy) * nx + ix, w))
    return taps


#: probe-table size cap for the differentiable pass's two-level tables
#: (None = fast.py's default).  The round-5 forward sweep found coarse
#: bricks (~51^3 voxels, max_bricks 8192) remove 40% of rows at 1024^3
#: — the same transit-row economics apply to the replay.  Module-level
#: because render_diff's custom_vjp signature is fixed; set it BEFORE
#: the first traced call (the brick shape is baked at trace time, and
#: fwd/bwd must agree — both read it through this function).
DIFF_MAX_BRICKS = None

#: cascade pool shrink factor for the cascaded replay (fast.py
#: semantics; may be fractional).  Same trace-time caveat as
#: DIFF_MAX_BRICKS.
DIFF_CASCADE_FACTOR = 2


def _build_brick_tab(density_data):
    """Two-level majorant tables for the differentiable pass: dilated
    per-brick majorants with multiplicative+additive *headroom* so the
    null-collision score term -1/(rho_maxb - rho) stays bounded at the
    brick's argmax voxel (any valid majorant keeps the estimator exact),
    plus the Chebyshev empty-space leap channel.  Majorants are
    stop-gradient by construction of the estimator."""
    dd = jax.lax.stop_gradient(density_data)
    brick = fast.pick_brick(
        dd.shape,
        *(() if DIFF_MAX_BRICKS is None else (DIFF_MAX_BRICKS,)),
    )
    major = fast.brick_majorants(dd, brick)
    # generous headroom: the null score is -1/(maj - rho), so a tight
    # majorant (forward-optimal) makes the gradient variance explode
    # wherever the field is locally near-constant.  10% of the grid max
    # bounds the null score at ~-10/max while keeping the estimator
    # exact (any valid majorant is).
    slack = 0.1 * jnp.maximum(jnp.max(dd), 1e-6)
    major = jnp.where(major > 0.0, major * 1.05 + slack, 0.0)
    cheb = fast.brick_chebyshev_distance(major)
    return major, cheb, brick


class _ReplayState(NamedTuple):
    o: jnp.ndarray
    d: jnp.ndarray
    throughput: jnp.ndarray
    radiance: jnp.ndarray
    alive: jnp.ndarray
    rng: RngState
    d_density: jnp.ndarray  # flat (Nvox,) cotangent accumulator
    d_albedo: jnp.ndarray  # flat (Nvox, C) cotangent accumulator


def _replay_bounce(scene, settings, st, s_lane, g_lane, record):
    """One bounce identical to integrator.bounce_step, optionally
    scatter-adding adjoints (record=True for pass B)."""
    med = scene.medium
    o, d, tput, rad, alive, rng = (
        st.o, st.d, st.throughput, st.radiance, st.alive, st.rng
    )
    d_density, d_albedo = st.d_density, st.d_albedo

    isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
    miss = jnp.logical_and(alive, jnp.logical_not(isect.hit))
    rad = jnp.where(miss[..., None], rad + tput * scene.le, rad)
    alive = jnp.logical_and(alive, isect.hit)
    in_medium = jnp.logical_and(alive, isect.inside_volume)

    # --- Woodcock with score-function recording --------------------------
    scale = med.scale
    rho_max = med.max_density
    inv_sigmat = 1.0 / (scale * rho_max)
    extent = med.box_max - med.box_min
    t0 = jnp.zeros(isect.dist.shape, jnp.float32)

    def wcond(c):
        return jnp.any(c[2])

    def wbody(c):
        t, rng_c, running, dd = c
        u1, rng_c = next_float(rng_c, running)
        step = -jnp.log(jnp.maximum(u1, EPSILON)) * inv_sigmat
        t_new = t + step
        p = o + t_new[..., None] * d
        p01 = (p - med.box_min) / extent
        rho = sample(med.density, p01, settings.interpolation)
        u2, rng_c = next_float(rng_c, running)
        overran = t_new > isect.dist
        accepted = jnp.logical_not(scale * rho * inv_sigmat < u2)
        # Score terms: every *evaluated* collision inside [0, max_t]
        # contributes; overruns past the boundary were never realized
        # collisions (the reference evaluates the density there but the
        # event is discarded), so they carry no score.
        if record:
            is_real = jnp.logical_and(
                running, jnp.logical_and(accepted, jnp.logical_not(overran))
            )
            is_null = jnp.logical_and(
                running,
                jnp.logical_and(jnp.logical_not(accepted),
                                jnp.logical_not(overran)),
            )
            score = jnp.where(
                is_real,
                1.0 / jnp.maximum(rho, 1e-8),
                jnp.where(
                    is_null, -1.0 / jnp.maximum(rho_max - rho, 1e-8), 0.0
                ),
            )
            val = s_lane * score
            for idx, w in _trilerp_taps(
                med.density.data.shape, med.box_min, med.box_max, p
            ):
                dd = dd.at[idx].add(val * w, mode="drop")
        terminated = jnp.logical_or(overran, accepted)
        t = jnp.where(running, t_new, t)
        running = jnp.logical_and(running, jnp.logical_not(terminated))
        return (t, rng_c, running, dd)

    t_w, rng, _, d_density = jax.lax.while_loop(
        wcond, wbody, (t0, rng, in_medium, d_density)
    )
    scattered = jnp.logical_and(in_medium, t_w < isect.dist)
    boundary = jnp.logical_and(alive, jnp.logical_not(scattered))

    # --- boundary event ---------------------------------------------------
    o_bound = o + d * isect.dist[..., None]
    fx, fy, fz = math3.frame_from_z(isect.normal)
    wi_local = math3.to_local(fx, fy, fz, math3.normalize(-d))
    if settings.bsdf_kind == "ggx":
        wo_local, weight, valid, rng = ggx.ggx_sample(
            scene.bsdf.roughness, scene.bsdf.eta, wi_local, rng,
            active=boundary,
            mitsuba_comparable=settings.mitsuba_comparable,
        )
        d_bsdf = math3.to_world(fx, fy, fz, wo_local)
    else:
        weight = jnp.ones(wi_local.shape[:-1], jnp.float32)
        valid = jnp.ones(wi_local.shape[:-1], bool)
        d_bsdf = d
    bsdf_ok = jnp.logical_and(boundary, valid)
    o_b = jnp.where(bsdf_ok[..., None], o_bound + d_bsdf * EPSILON, o_bound)
    d_b = jnp.where(bsdf_ok[..., None], d_bsdf, d)
    t_b = jnp.where(bsdf_ok[..., None], tput * weight[..., None], tput)

    # --- scatter event + albedo adjoint ----------------------------------
    o_s = o + d * t_w[..., None] - d * EPSILON
    albedo = integrator.sample_albedo(scene, o_s, settings)
    if record:
        # dC/d albedo_c(x) = C_c / albedo_c(x); cotangent g_lane_c.
        adj = jnp.where(
            scattered[..., None],
            g_lane / jnp.maximum(albedo, 1e-8),
            0.0,
        )
        pad = jnp.zeros(adj.shape[:-1] + (1,), jnp.float32)  # alpha chan
        adj4 = jnp.concatenate([adj, pad], axis=-1)
        for idx, w in _trilerp_taps(
            scene.medium.albedo.data.shape, med.box_min, med.box_max, o_s
        ):
            d_albedo = d_albedo.at[idx].add(adj4 * w[..., None], mode="drop")
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
        scattered[..., None], tput * albedo,
        jnp.where(boundary[..., None], t_b, tput),
    )

    if settings.russian_roulette:
        p_survive = jnp.minimum(1.0, math3.max3(tput))
        u, rng = next_float(rng, alive)
        killed = jnp.logical_and(alive, u > p_survive)
        alive = jnp.logical_and(alive, jnp.logical_not(killed))
        tput = jnp.where(
            alive[..., None],
            tput / jnp.maximum(p_survive, 1e-20)[..., None],
            tput,
        )

    return _ReplayState(
        o=o, d=d, throughput=tput, radiance=rad, alive=alive, rng=rng,
        d_density=d_density, d_albedo=d_albedo,
    )


def _replay_bounce_2l(scene, settings, st, s_lane, g_lane, record, tables):
    """Two-level, stochastic-tap variant of _replay_bounce: per-brick
    dilated majorants (with score headroom) + Chebyshev empty-space
    leaps + single-tap stochastic trilinear filtering — the fastSK
    estimator family (models/fast.py), made differentiable.  Adjoints
    scatter to ONE tap per density evaluation instead of eight, and the
    local-majorant null score uses the same brick majorant the sampler
    used.  Forward and backward run this same function, so the replay
    is draw-exact by construction."""
    med = scene.medium
    major, cheb, brick = tables
    bz_, by_, bx_ = brick
    nz, ny, nx = med.density.data.shape
    nbz, nby, nbx = major.shape
    density_flat = med.density.data.reshape(-1)
    alb_shape = med.albedo.data.shape
    const_alb = all(s == 1 for s in alb_shape[:3])
    albedo_flat = med.albedo.data.reshape(-1, alb_shape[-1])
    res_minus_1 = jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.float32)
    extent = med.box_max - med.box_min
    scale = med.scale
    brick_size = jnp.asarray([bx_, by_, bz_], jnp.float32)
    brick_hi = jnp.asarray([nbx - 1, nby - 1, nbz - 1], jnp.int32)
    edge_world = brick_size * (extent / res_minus_1)
    min_edge = jnp.min(edge_world)
    major_flat = major.reshape(-1)
    leap_flat = (
        jnp.maximum(cheb.reshape(-1) - 1.0, 0.0) * min_edge * (1.0 - 1e-6)
    )

    o, d, tput, rad, alive, rng = (
        st.o, st.d, st.throughput, st.radiance, st.alive, st.rng
    )
    d_density, d_albedo = st.d_density, st.d_albedo

    isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
    miss = jnp.logical_and(alive, jnp.logical_not(isect.hit))
    rad = jnp.where(miss[..., None], rad + tput * scene.le, rad)
    alive = jnp.logical_and(alive, isect.hit)
    in_medium = jnp.logical_and(alive, isect.inside_volume)
    max_t = isect.dist
    epsw = jnp.max(extent) * 1e-6

    n_lanes = o.shape[0]
    zero1 = jnp.zeros((n_lanes,), jnp.float32)

    def wcond(c):
        return jnp.any(c[0])

    def wbody(c):
        (running, t, brick_exit, inv_sig, rho_loc, scattered, tap_saved,
         rng_c, dd, da) = c
        need_brick = jnp.logical_and(running, t >= brick_exit)
        p_now = o + (t + epsw)[..., None] * d
        coordn = (
            jnp.clip((p_now - med.box_min) / extent, 0.0, 1.0)
            * res_minus_1
        )
        bi = jnp.clip(
            jnp.floor(coordn / brick_size).astype(jnp.int32), 0, brick_hi
        )
        bflat = (bi[..., 2] * nby + bi[..., 1]) * nbx + bi[..., 0]
        idx_b = jnp.where(need_brick, bflat, 0)
        rho_b = jnp.take(major_flat, idx_b, axis=0)
        leap_b = jnp.take(leap_flat, idx_b, axis=0)
        up = (d > 0.0).astype(jnp.float32)
        bound_coord = (bi.astype(jnp.float32) + up) * brick_size
        bound_world = med.box_min + extent * bound_coord / res_minus_1
        okd = jnp.abs(d) > 1e-12
        t_axes = jnp.where(
            okd, (bound_world - o) / jnp.where(okd, d, 1.0), jnp.inf
        )
        exit_new = jnp.maximum(jnp.min(t_axes, axis=-1), t + epsw)
        brick_exit = jnp.where(need_brick, exit_new, brick_exit)
        inv_sig = jnp.where(
            need_brick,
            jnp.where(
                rho_b > 0.0,
                1.0 / (scale * jnp.maximum(rho_b, 1e-30)),
                jnp.inf,
            ),
            inv_sig,
        )
        rho_loc = jnp.where(need_brick, rho_b, rho_loc)

        probe_empty = jnp.logical_and(need_brick, rho_b <= 0.0)
        t_leap = jnp.maximum(exit_new, t + leap_b)
        overran_empty = jnp.logical_and(probe_empty, t_leap >= max_t)

        stepping = jnp.logical_and(running, jnp.logical_not(probe_empty))
        u1, rng_c = next_float(rng_c, stepping)
        step = jnp.where(
            stepping,
            -jnp.log(jnp.maximum(u1, EPSILON)) * inv_sig,
            0.0,
        )
        t_cand = t + step
        eff_exit = jnp.minimum(brick_exit, max_t)
        crossed = jnp.logical_and(stepping, t_cand >= eff_exit)
        inside = jnp.logical_and(stepping, jnp.logical_not(crossed))

        p = o + t_cand[..., None] * d
        coord = (
            jnp.clip((p - med.box_min) / extent, 0.0, 1.0) * res_minus_1
        )
        tap_bits, rng_c = next_uint32(rng_c, inside)
        tap = fast._stochastic_tap(coord, tap_bits)
        ix = jnp.clip(tap[..., 0], 0, nx - 1)
        iy = jnp.clip(tap[..., 1], 0, ny - 1)
        iz = jnp.clip(tap[..., 2], 0, nz - 1)
        tap_flat = (iz * ny + iy) * nx + ix
        rho = jnp.take(
            density_flat, jnp.where(inside, tap_flat, 0), axis=0
        )
        u2, rng_c = next_float(rng_c, inside)
        accepted = jnp.logical_and(
            inside, jnp.logical_not(scale * rho * inv_sig < u2)
        )
        if record:
            # single-tap score terms with the LOCAL majorant
            is_null = jnp.logical_and(inside, jnp.logical_not(accepted))
            score = jnp.where(
                accepted,
                1.0 / jnp.maximum(rho, 1e-8),
                jnp.where(
                    is_null,
                    -1.0 / jnp.maximum(rho_loc - rho, 1e-8),
                    0.0,
                ),
            )
            dd = dd.at[jnp.where(inside, tap_flat, len(density_flat))].add(
                s_lane * score, mode="drop"
            )

        overran_step = jnp.logical_and(crossed, max_t <= brick_exit)
        transit = jnp.logical_and(
            crossed, jnp.logical_not(overran_step)
        )
        t = jnp.where(
            probe_empty,
            jnp.minimum(t_leap, max_t),
            jnp.where(
                transit,
                brick_exit,
                jnp.where(
                    overran_step,
                    jnp.maximum(t, max_t),
                    jnp.where(inside, t_cand, t),
                ),
            ),
        )
        brick_exit = jnp.where(probe_empty, -1.0, brick_exit)
        done = jnp.logical_or(
            accepted, jnp.logical_or(overran_step, overran_empty)
        )
        scattered = jnp.logical_or(scattered, accepted)
        tap_saved = jnp.where(accepted, tap_flat, tap_saved)
        running = jnp.logical_and(running, jnp.logical_not(done))
        return (
            running, t, brick_exit, inv_sig, rho_loc, scattered,
            tap_saved, rng_c, dd, da,
        )

    init = (
        in_medium, zero1, zero1 - 1.0, zero1, zero1,
        jnp.zeros((n_lanes,), bool), jnp.zeros((n_lanes,), jnp.int32),
        rng, d_density, d_albedo,
    )
    (_, t_w, _, _, _, scattered, tap_saved, rng, d_density,
     d_albedo) = jax.lax.while_loop(wcond, wbody, init)
    boundary = jnp.logical_and(alive, jnp.logical_not(scattered))

    # --- boundary event (shared physics helpers) --------------------------
    o_bound = o + d * isect.dist[..., None]
    o_b, d_b, t_b, rng = integrator.boundary_event(
        scene, settings, isect.normal, o_bound, d, tput, rng, boundary
    )

    # --- scatter event: albedo at the accepted tap ------------------------
    alb_idx = jnp.zeros_like(tap_saved) if const_alb else tap_saved
    alb_row = jnp.take(albedo_flat, alb_idx, axis=0)
    albedo = alb_row[..., :3]
    if record:
        adj = jnp.where(
            scattered[..., None],
            g_lane / jnp.maximum(albedo, 1e-8),
            0.0,
        )
        pad = jnp.zeros(adj.shape[:-1] + (1,), jnp.float32)
        adj4 = jnp.concatenate([adj, pad], axis=-1)[
            ..., : alb_shape[-1]
        ]
        if const_alb:
            # constant albedo: a full-width scatter onto a 1-row table
            # is degenerate — reduce instead
            d_albedo = d_albedo + jnp.sum(adj4, axis=0, keepdims=True)
        else:
            d_albedo = d_albedo.at[
                jnp.where(scattered, alb_idx, albedo_flat.shape[0])
            ].add(adj4, mode="drop")
    d_s, rng = phase.sample_phase(d, med.g, rng, active=scattered)

    o_s = o + d * t_w[..., None] - d * EPSILON
    o = jnp.where(
        scattered[..., None], o_s,
        jnp.where(boundary[..., None], o_b, o),
    )
    d = jnp.where(scattered[..., None], d_s, d_b)
    tput = jnp.where(scattered[..., None], tput * albedo, t_b)

    if settings.russian_roulette:
        tput, alive, _, rng = integrator.russian_roulette(
            tput, alive, rng, alive
        )

    return _ReplayState(
        o=o, d=d, throughput=tput, radiance=rad, alive=alive, rng=rng,
        d_density=d_density, d_albedo=d_albedo,
    )


def _replay_2l_fused(scene, settings, o0, d0, rng0, s_lane, g_lane,
                     record, d_density0, d_albedo0, tables,
                     cascade=True, cascade_factor=2, min_width=None):
    """Fused single-loop two-level replay with cascade tail compaction.

    The nested replay (outer while over bounces, inner while over
    Woodcock steps inside _replay_bounce_2l) runs every lane in
    BOUNCE-lockstep: each outer iteration waits for the slowest lane's
    free flight, and the outer loop runs to the LAST path's death —
    measured 17.4 s for a 512^2 primal at 1024^3 where the forward
    fastSK path does the same physics in ~0.1 s (PERF.md round-4
    fwd+bwd anatomy).  This version flattens both loops into ONE while
    over steps with a per-lane state machine (the fastSK structure,
    models/fast.py body()): each iteration a lane either starts a
    segment (AABB intersect), advances one tracking step, or applies
    its scatter/boundary event.  The per-lane draw SEQUENCE is
    identical to the nested replay (masked-RNG draws advance only the
    drawing lane's stream), so radiance/throughput are BIT-IDENTICAL —
    asserted by tests/test_grad.py::test_fused_replay_matches_nested.

    cascade=True (round 5) adds the forward cascade's tail compaction
    (models/fast.py flush_compact): pools of shrinking width; when the
    pending (alive) count fits the next pool, finished lanes write
    their per-lane results to lane-id-indexed output buffers and
    survivors argsort-compact into the narrower pool.  Pass A/B stop
    paying full width for the straggler tail (occupancy was decaying to
    ~0 over the drain).  Per-lane draw streams
    are untouched by compaction (RNG travels with the lane), so
    radiance/throughput stay bit-identical; cotangent buffers see a
    different scatter-add grouping (different pool partitions), so they
    agree to float-accumulation order (tested allclose).
    """
    med = scene.medium
    major, cheb, brick = tables
    bz_, by_, bx_ = brick
    nz, ny, nx = med.density.data.shape
    nbz, nby, nbx = major.shape
    density_flat = med.density.data.reshape(-1)
    alb_shape = med.albedo.data.shape
    const_alb = all(s == 1 for s in alb_shape[:3])
    albedo_flat = med.albedo.data.reshape(-1, alb_shape[-1])
    res_minus_1 = jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.float32)
    extent = med.box_max - med.box_min
    scale = med.scale
    brick_size = jnp.asarray([bx_, by_, bz_], jnp.float32)
    brick_hi = jnp.asarray([nbx - 1, nby - 1, nbz - 1], jnp.int32)
    edge_world = brick_size * (extent / res_minus_1)
    min_edge = jnp.min(edge_world)
    major_flat = major.reshape(-1)
    leap_flat = (
        jnp.maximum(cheb.reshape(-1) - 1.0, 0.0) * min_edge * (1.0 - 1e-6)
    )
    epsw = jnp.max(extent) * 1e-6
    n_lanes = o0.shape[0]
    zero1 = jnp.zeros((n_lanes,), jnp.float32)
    zerob = jnp.zeros((n_lanes,), bool)
    cap = jnp.int32(settings.max_path_length)

    def body(c):
        (o, d, tput, rad, alive, rng, bounce, seg, in_med, t,
         brick_exit, inv_sig, rho_loc, max_t, normal, lane_id,
         s_lane, g_lane, dd, da) = c

        # -- A: segment start (the nested bounce preamble) ----------------
        start = jnp.logical_and(alive, jnp.logical_not(seg))
        isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
        miss = jnp.logical_and(start, jnp.logical_not(isect.hit))
        rad = jnp.where(miss[..., None], rad + tput * scene.le, rad)
        alive = jnp.logical_and(alive, jnp.logical_not(miss))
        st2 = jnp.logical_and(start, isect.hit)
        seg = jnp.logical_or(seg, st2)
        t = jnp.where(st2, 0.0, t)
        brick_exit = jnp.where(st2, -1.0, brick_exit)
        inv_sig = jnp.where(st2, 0.0, inv_sig)
        rho_loc = jnp.where(st2, 0.0, rho_loc)
        max_t = jnp.where(st2, isect.dist, max_t)
        normal = jnp.where(st2[..., None], isect.normal, normal)
        in_med = jnp.where(st2, isect.inside_volume, in_med)
        # entering from outside: no tracking — straight to boundary
        imm_bnd = jnp.logical_and(st2, jnp.logical_not(isect.inside_volume))

        # -- B: one two-level tracking step (wbody of the nested code) ----
        running = jnp.logical_and(jnp.logical_and(seg, alive), in_med)
        need_brick = jnp.logical_and(running, t >= brick_exit)
        p_now = o + (t + epsw)[..., None] * d
        coordn = (
            jnp.clip((p_now - med.box_min) / extent, 0.0, 1.0)
            * res_minus_1
        )
        bi = jnp.clip(
            jnp.floor(coordn / brick_size).astype(jnp.int32), 0, brick_hi
        )
        bflat = (bi[..., 2] * nby + bi[..., 1]) * nbx + bi[..., 0]
        idx_b = jnp.where(need_brick, bflat, 0)
        rho_b = jnp.take(major_flat, idx_b, axis=0)
        leap_b = jnp.take(leap_flat, idx_b, axis=0)
        up = (d > 0.0).astype(jnp.float32)
        bound_coord = (bi.astype(jnp.float32) + up) * brick_size
        bound_world = med.box_min + extent * bound_coord / res_minus_1
        okd = jnp.abs(d) > 1e-12
        t_axes = jnp.where(
            okd, (bound_world - o) / jnp.where(okd, d, 1.0), jnp.inf
        )
        exit_new = jnp.maximum(jnp.min(t_axes, axis=-1), t + epsw)
        brick_exit = jnp.where(need_brick, exit_new, brick_exit)
        inv_sig = jnp.where(
            need_brick,
            jnp.where(
                rho_b > 0.0,
                1.0 / (scale * jnp.maximum(rho_b, 1e-30)),
                jnp.inf,
            ),
            inv_sig,
        )
        rho_loc = jnp.where(need_brick, rho_b, rho_loc)

        probe_empty = jnp.logical_and(need_brick, rho_b <= 0.0)
        t_leap = jnp.maximum(exit_new, t + leap_b)
        overran_empty = jnp.logical_and(probe_empty, t_leap >= max_t)

        stepping = jnp.logical_and(running, jnp.logical_not(probe_empty))
        u1, rng = next_float(rng, stepping)
        step = jnp.where(
            stepping,
            -jnp.log(jnp.maximum(u1, EPSILON)) * inv_sig,
            0.0,
        )
        t_cand = t + step
        eff_exit = jnp.minimum(brick_exit, max_t)
        crossed = jnp.logical_and(stepping, t_cand >= eff_exit)
        inside = jnp.logical_and(stepping, jnp.logical_not(crossed))

        p = o + t_cand[..., None] * d
        coord = (
            jnp.clip((p - med.box_min) / extent, 0.0, 1.0) * res_minus_1
        )
        tap_bits, rng = next_uint32(rng, inside)
        tap = fast._stochastic_tap(coord, tap_bits)
        ix = jnp.clip(tap[..., 0], 0, nx - 1)
        iy = jnp.clip(tap[..., 1], 0, ny - 1)
        iz = jnp.clip(tap[..., 2], 0, nz - 1)
        tap_flat = (iz * ny + iy) * nx + ix
        rho = jnp.take(
            density_flat, jnp.where(inside, tap_flat, 0), axis=0
        )
        u2, rng = next_float(rng, inside)
        accepted = jnp.logical_and(
            inside, jnp.logical_not(scale * rho * inv_sig < u2)
        )
        if record:
            is_null = jnp.logical_and(inside, jnp.logical_not(accepted))
            score = jnp.where(
                accepted,
                1.0 / jnp.maximum(rho, 1e-8),
                jnp.where(
                    is_null,
                    -1.0 / jnp.maximum(rho_loc - rho, 1e-8),
                    0.0,
                ),
            )
            dd = dd.at[
                jnp.where(inside, tap_flat, len(density_flat))
            ].add(s_lane * score, mode="drop")

        overran_step = jnp.logical_and(crossed, max_t <= brick_exit)
        transit = jnp.logical_and(crossed, jnp.logical_not(overran_step))
        t = jnp.where(
            probe_empty,
            jnp.minimum(t_leap, max_t),
            jnp.where(
                transit,
                brick_exit,
                jnp.where(
                    overran_step,
                    jnp.maximum(t, max_t),
                    jnp.where(inside, t_cand, t),
                ),
            ),
        )
        brick_exit = jnp.where(probe_empty, -1.0, brick_exit)

        # -- C: events for lanes whose segment just completed -------------
        scat_now = accepted
        trk_done = jnp.logical_or(
            accepted, jnp.logical_or(overran_step, overran_empty)
        )
        bnd_now = jnp.logical_or(
            jnp.logical_and(trk_done, jnp.logical_not(accepted)), imm_bnd
        )
        done_now = jnp.logical_or(trk_done, imm_bnd)
        seg = jnp.logical_and(seg, jnp.logical_not(done_now))

        o_bound = o + d * max_t[..., None]
        o_b, d_b, t_b, rng = integrator.boundary_event(
            scene, settings, normal, o_bound, d, tput, rng, bnd_now
        )

        alb_idx = jnp.zeros_like(tap_flat) if const_alb else tap_flat
        alb_row = jnp.take(
            albedo_flat, jnp.where(scat_now, alb_idx, 0), axis=0
        )
        albedo = alb_row[..., :3]
        if record:
            adj = jnp.where(
                scat_now[..., None],
                g_lane / jnp.maximum(albedo, 1e-8),
                0.0,
            )
            pad = jnp.zeros(adj.shape[:-1] + (1,), jnp.float32)
            adj4 = jnp.concatenate([adj, pad], axis=-1)[
                ..., : alb_shape[-1]
            ]
            if const_alb:
                da = da + jnp.sum(adj4, axis=0, keepdims=True)
            else:
                da = da.at[
                    jnp.where(scat_now, alb_idx, albedo_flat.shape[0])
                ].add(adj4, mode="drop")
        d_s, rng = phase.sample_phase(d, med.g, rng, active=scat_now)

        o_s = o + d * t[..., None] - d * EPSILON
        o = jnp.where(
            scat_now[..., None], o_s,
            jnp.where(bnd_now[..., None], o_b, o),
        )
        d = jnp.where(
            scat_now[..., None], d_s,
            jnp.where(bnd_now[..., None], d_b, d),
        )
        tput = jnp.where(
            scat_now[..., None], tput * albedo,
            jnp.where(bnd_now[..., None], t_b, tput),
        )

        if settings.russian_roulette:
            tput, alive, _, rng = integrator.russian_roulette(
                tput, alive, rng, jnp.logical_and(done_now, alive)
            )

        bounce = jnp.where(done_now, bounce + 1, bounce)
        alive = jnp.logical_and(
            alive,
            jnp.logical_not(jnp.logical_and(done_now, bounce >= cap)),
        )
        return (o, d, tput, rad, alive, rng, bounce, seg, in_med, t,
                brick_exit, inv_sig, rho_loc, max_t, normal, lane_id,
                s_lane, g_lane, dd, da)

    # -- cascade over shrinking pools (forward flush_compact mirrored) ----
    as_f = lambda x: jax.lax.bitcast_convert_type(x, jnp.float32)
    as_i = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
    as_u = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint32)

    def pack(c):
        """Per-lane pool state → one (W, 31) f32 matrix so compaction
        is a single packed row gather (fast.py _pack pattern)."""
        (o, d, tput, rad, alive, rng, bounce, seg, in_med, t,
         brick_exit, inv_sig, rho_loc, max_t, normal, lane_id,
         s_l, g_l, _, _) = c
        cols = [
            o, d, tput, rad, normal,
            t[:, None], brick_exit[:, None], inv_sig[:, None],
            rho_loc[:, None], max_t[:, None],
            s_l[:, None], g_l,
            as_f(bounce)[:, None], as_f(lane_id)[:, None],
            as_f(rng.state.astype(jnp.int32))[:, None],
            as_f(rng.inc.astype(jnp.int32))[:, None],
            as_f(alive.astype(jnp.int32))[:, None],
            as_f(seg.astype(jnp.int32))[:, None],
            as_f(in_med.astype(jnp.int32))[:, None],
        ]
        return jnp.concatenate(cols, axis=1)

    def unpack(mat, dd, da):
        return (
            mat[:, 0:3], mat[:, 3:6], mat[:, 6:9], mat[:, 9:12],
            as_i(mat[:, 28]) != 0,  # alive
            RngState(state=as_u(mat[:, 26]), inc=as_u(mat[:, 27])),
            as_i(mat[:, 24]),  # bounce
            as_i(mat[:, 29]) != 0,  # seg
            as_i(mat[:, 30]) != 0,  # in_med
            mat[:, 15], mat[:, 16], mat[:, 17], mat[:, 18], mat[:, 19],
            mat[:, 12:15],  # normal
            as_i(mat[:, 25]),  # lane_id
            mat[:, 20], mat[:, 21:24],  # s_l, g_l
            dd, da,
        )

    n_total = n_lanes
    if cascade:
        if min_width is None:
            min_width = fast._default_min_width()
        widths = fast._cascade_widths(n_total, cascade_factor, min_width)
    else:
        widths = [n_total]

    # lane-id-indexed per-lane output buffers: a finished lane writes
    # its final state here at flush time, restoring original lane order
    out_o = jnp.zeros((n_total, 3), jnp.float32)
    out_d = jnp.zeros((n_total, 3), jnp.float32)
    out_tput = jnp.zeros((n_total, 3), jnp.float32)
    out_rad = jnp.zeros((n_total, 3), jnp.float32)

    carry = (
        o0, d0,
        jnp.ones((n_total, 3), jnp.float32),
        jnp.zeros((n_total, 3), jnp.float32),
        jnp.ones((n_total,), bool),
        rng0,
        jnp.zeros((n_total,), jnp.int32),
        zerob, zerob,
        zero1, zero1 - 1.0, zero1, zero1, zero1,
        jnp.zeros((n_total, 3), jnp.float32),
        jnp.arange(n_total, dtype=jnp.int32),
        s_lane, g_lane,
        d_density0, d_albedo0,
    )

    def flush(c, outs):
        """Write finished lanes' final state to the lane-id buffers.
        A dead lane's per-lane fields never change again (every update
        is masked by alive), so re-flushing a dead lane that survived a
        pool cut rewrites identical values — no double counting."""
        out_o, out_d, out_tput, out_rad = outs
        alive, lane_id = c[4], c[15]
        idx = jnp.where(alive, n_total, lane_id)  # n_total drops
        out_o = out_o.at[idx].set(c[0], mode="drop")
        out_d = out_d.at[idx].set(c[1], mode="drop")
        out_tput = out_tput.at[idx].set(c[2], mode="drop")
        out_rad = out_rad.at[idx].set(c[3], mode="drop")
        return out_o, out_d, out_tput, out_rad

    outs = (out_o, out_d, out_tput, out_rad)
    for stage, width in enumerate(widths):
        last = stage == len(widths) - 1
        thresh = 0 if last else widths[stage + 1]
        # narrow pools may chain several complete body evaluations per
        # while-iteration (masked draws keep per-lane streams identical;
        # evaluations past the exit condition are no-ops) — the forward
        # tail_chain, with its default (fast._TAIL_CHAIN)
        k_chain = (
            fast._TAIL_CHAIN if (len(widths) > 1 and width <= 4096) else 1
        )

        def cond(c, _thresh=thresh):
            return jnp.sum(c[4].astype(jnp.int32)) > _thresh

        carry = jax.lax.while_loop(
            cond, fast.chain_body(body, k_chain), carry
        )
        outs = flush(carry, outs)
        if not last:
            dd, da = carry[18], carry[19]
            order = jnp.argsort(
                jnp.logical_not(carry[4]).astype(jnp.int32)
            )[: widths[stage + 1]]
            packed = jnp.take(pack(carry), order, axis=0)
            carry = unpack(packed, dd, da)

    out_o, out_d, out_tput, out_rad = outs
    dd, da = carry[18], carry[19]
    # NOTE: rng is the INITIAL state, not the post-replay stream — the
    # final per-lane states live pool-permuted in the carry and no
    # caller continues sampling from a replay's rng.  Do not chain a
    # second estimator pass off this field.
    return _ReplayState(
        o=out_o, d=out_d, throughput=out_tput, radiance=out_rad,
        alive=jnp.zeros((n_total,), bool), rng=rng0,
        d_density=dd, d_albedo=da,
    )


#: default for the cascaded replay (benchmark drivers may flip this for
#: A/B runs against the single-pool fused replay)
REPLAY_CASCADE: bool = True


def _replay(scene, settings, o0, d0, rng0, s_lane, g_lane, record,
            d_density0, d_albedo0, tables=None, fused=True,
            cascade=None):
    if cascade is None:
        cascade = REPLAY_CASCADE
    if tables is not None and fused:
        return _replay_2l_fused(
            scene, settings, o0, d0, rng0, s_lane, g_lane, record,
            d_density0, d_albedo0, tables, cascade=cascade,
            cascade_factor=DIFF_CASCADE_FACTOR,
        )
    n = o0.shape[:-1]
    st = _ReplayState(
        o=o0, d=d0,
        throughput=jnp.ones(n + (3,), jnp.float32),
        radiance=jnp.zeros(n + (3,), jnp.float32),
        alive=jnp.ones(n, bool),
        rng=rng0,
        d_density=d_density0, d_albedo=d_albedo0,
    )

    def cond(c):
        st, bounce = c
        return jnp.logical_and(
            jnp.any(st.alive), bounce < settings.max_path_length
        )

    def body(c):
        st, bounce = c
        if tables is not None:
            nxt = _replay_bounce_2l(
                scene, settings, st, s_lane, g_lane, record, tables
            )
        else:
            nxt = _replay_bounce(scene, settings, st, s_lane, g_lane, record)
        return (nxt, bounce + 1)

    final, _ = jax.lax.while_loop(cond, body, (st, jnp.int32(0)))
    return final


def _lane_setup(camera_obj, resolution, spp, seed):
    tw, th = resolution
    n_lanes = tw * th * spp
    image_id, pixel_xy = naive.lane_pixels(
        n_lanes, resolution, jnp.zeros(2, jnp.float32)
    )
    path_id = jnp.arange(n_lanes, dtype=jnp.uint32)
    rng = make_rng(seed, path_id)
    o0, d0, rng = cam.generate_rays(
        camera_obj, pixel_xy, resolution, rng
    )
    return n_lanes, image_id, o0, d0, rng


@partial(
    jax.custom_vjp,
    nondiff_argnums=(3, 4, 5, 6, 7, 8),
)
def render_diff(
    density_data,
    albedo_data,
    seed,
    scene_spec: SceneSpec,
    camera_spec: CameraSpec,
    settings: RenderSettings,
    resolution: Tuple[int, int],
    spp: int,
    two_level: bool = False,
    camera=None,
):
    """Differentiable render: image (H, W, 3) from grid parameters.

    scene_spec/camera_spec supply everything except the grids and are
    hashable compile-time constants.  two_level=True switches forward
    AND backward to the sparse-leap stochastic-tap estimator family
    (fastSK's) — required for large sparse grids where global-majorant
    tracking is intractable.

    `camera` (optional, TRACED ops.camera.Camera pytree, zero cotangent)
    overrides camera_spec's pose: multi-view optimization cycles camera
    values through ONE compiled step instead of recompiling the replay
    per view.
    """
    scene = scene_spec.build(density_data, albedo_data)
    cam_obj = camera if camera is not None else camera_spec.build()
    if two_level:
        img, _ = _primal_2l(
            scene, cam_obj, settings, resolution, spp, seed,
            density_data, albedo_data,
        )
        return img
    img, _ = naive.render_tile(
        scene, cam_obj, settings, resolution,
        jnp.zeros(2, jnp.float32), resolution, spp, seed, 0,
    )
    return img


def _primal_2l(scene, cam_obj, settings, resolution, spp, seed,
               density_data, albedo_data):
    """Two-level primal: (image, per-lane radiance).  The SINGLE source
    of the primal estimator for both render_diff and _fwd — _bwd's
    pass-A elision is correct precisely because the saved radiance IS
    this function's radiance, so there must be one copy of it."""
    tw, th = resolution
    tables = _build_brick_tab(density_data)
    n_lanes, image_id, o0, d0, rng = _lane_setup(
        cam_obj, resolution, spp, seed
    )
    out = _replay(
        scene, settings, o0, d0, rng,
        jnp.zeros((n_lanes,), jnp.float32),
        jnp.zeros((n_lanes, 3), jnp.float32),
        False, jnp.zeros((0,), jnp.float32),
        jnp.zeros((0, albedo_data.shape[-1]), jnp.float32), tables,
    )
    img = (
        jnp.zeros((tw * th, 3), jnp.float32)
        .at[image_id]
        .add(out.radiance)
    ).reshape(th, tw, 3)
    return img, out.radiance


def _fwd(density_data, albedo_data, seed, scene_spec, camera_spec,
         settings, resolution, spp, two_level=False, camera=None):
    if two_level:
        # Run the primal replay and save its per-lane radiance as a
        # residual: pass A of the backward recomputes exactly this
        # quantity (same replay, record=False), so carrying the (N, 3)
        # buffer (3 MB at 512^2) deletes one of the three path
        # traversals outright — the gradient becomes primal + pass B.
        # Bit-identical by construction: c_lane IS the primal's
        # radiance (one copy of the estimator: _primal_2l).
        scene = scene_spec.build(density_data, albedo_data)
        cam_obj = camera if camera is not None else camera_spec.build()
        img, radiance = _primal_2l(
            scene, cam_obj, settings, resolution, spp, seed,
            density_data, albedo_data,
        )
        return img, (density_data, albedo_data, seed, camera, radiance)
    img = render_diff(
        density_data, albedo_data, seed, scene_spec, camera_spec,
        settings, resolution, spp, two_level, camera,
    )
    return img, (density_data, albedo_data, seed, camera, None)


def _bwd(scene_spec, camera_spec, settings, resolution, spp, two_level,
         residuals, g_img):
    density_data, albedo_data, seed, camera, c_saved = residuals
    scene = scene_spec.build(density_data, albedo_data)
    cam_obj = camera if camera is not None else camera_spec.build()
    tables = _build_brick_tab(density_data) if two_level else None
    n_lanes, image_id, o0, d0, rng = _lane_setup(
        cam_obj, resolution, spp, seed
    )

    zero_d = jnp.zeros((density_data.size,), jnp.float32)
    zero_a = jnp.zeros(
        (albedo_data.size // albedo_data.shape[-1], albedo_data.shape[-1]),
        jnp.float32,
    )

    if c_saved is not None:
        # per-lane contributions saved by _fwd (the primal replay's own
        # radiance) — pass A is unnecessary
        c_lane = c_saved
    else:
        # Pass A: recompute per-lane contributions C.  record=False
        # never touches the cotangent buffers, so thread dummies —
        # carrying the real (V,) accumulator here would keep a second
        # whole-grid buffer live (4.3 GB at 1024^3).
        pass_a = _replay(
            scene, settings, o0, d0, rng,
            jnp.zeros((n_lanes,), jnp.float32),
            jnp.zeros((n_lanes, 3), jnp.float32), False,
            jnp.zeros((0,), jnp.float32),
            jnp.zeros((0, albedo_data.shape[-1]), jnp.float32),
            tables,
        )
        c_lane = pass_a.radiance  # (N, 3)
    g_pix = g_img.reshape(-1, 3)
    g_lane = jnp.take(g_pix, image_id, axis=0) * c_lane  # (N, 3) g_c * C_c
    s_lane = jnp.sum(g_lane, axis=-1)  # (N,)

    # Pass B: replay with adjoint scatter.
    pass_b = _replay(
        scene, settings, o0, d0, rng, s_lane, g_lane, True, zero_d, zero_a,
        tables,
    )
    d_density = pass_b.d_density.reshape(density_data.shape)
    d_albedo = pass_b.d_albedo.reshape(albedo_data.shape)
    import numpy as _np

    ct_seed = _np.zeros(jnp.shape(seed), jax.dtypes.float0)
    # camera pose is a parameter of the estimator, not a differentiated
    # quantity: zero cotangent (None camera stays None)
    ct_camera = (
        None if camera is None
        else jax.tree_util.tree_map(jnp.zeros_like, camera)
    )
    return d_density, d_albedo, ct_seed, ct_camera


render_diff.defvjp(_fwd, _bwd)
