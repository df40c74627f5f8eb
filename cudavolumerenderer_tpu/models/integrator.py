"""Shared volumetric path-tracing physics over a ray wavefront.

This module is the wavefront re-expression of the bounce body that every
reference kernel repeats verbatim (reference:
implementation/src/NaiveVolPTsk_kernel.cuh:35-86 and the identical blocks in
the regeneration/streaming/sorting kernels): intersect the medium AABB →
Woodcock free-flight sampling → either an HG scatter event or a GGX
boundary event → Russian roulette.  Instead of one CUDA thread per path,
the whole wavefront advances through one bounce as a masked array program;
the scheduling strategies in the sibling modules differ only in how lanes
are (re)filled and compacted around this step, exactly mirroring the
reference's kernel family (SURVEY.md §2.5).

Masked-RNG discipline: every stochastic sub-step draws only on the lanes
that take it, so a path's random stream is identical no matter which
scheduler executes it — the property that makes images shard- and
batch-invariant.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..constants import EPSILON
from ..ops import aabb, ggx, gradient, math3, phase, woodcock
from ..ops.grid import sample
from ..ops.rng import RngState, next_float
from ..scene.types import RenderSettings, Scene


class PathState(NamedTuple):
    """SoA wavefront state (reference AoS analog: Ray.h:19-57)."""

    o: jnp.ndarray  # (N, 3) origins
    d: jnp.ndarray  # (N, 3) directions
    throughput: jnp.ndarray  # (N, 3)
    radiance: jnp.ndarray  # (N, 3) accumulated per-lane contribution
    alive: jnp.ndarray  # (N,) bool
    rng: RngState  # per-lane RNG
    n_rays: jnp.ndarray  # () int64-ish f32 counter of traced rays


def sample_albedo(scene: Scene, p: jnp.ndarray, settings: RenderSettings):
    """Albedo at a world point (reference: Medium.h:145-148): proper box
    normalization then a volume fetch; returns (..., 3) rgb."""
    med = scene.medium
    p01 = aabb.aabb_transform(med.box_min, med.box_max, p)
    a = sample(med.albedo, p01, settings.interpolation)
    return a[..., :3]


def boundary_event(scene, settings, normal, o_bound, d, tput, rng, mask):
    """Shared boundary event (reference: the GGX block every kernel
    repeats, e.g. NaiveVolPTsk_kernel.cuh:53-66): local frame from the
    cached face normal, GGX reflect/refract (weight = G1) or the null
    pass-through BSDF; invalid microfacet samples leave direction and
    throughput unchanged from the boundary point, exactly as the
    reference does.  Returns (o_out, d_out, tput_out, rng) with updates
    applied only on ``mask`` lanes (others pass through untouched)."""
    fx, fy, fz = math3.frame_from_z(normal)
    wi_local = math3.to_local(fx, fy, fz, math3.normalize(-d))
    if settings.bsdf_kind == "ggx":
        wo_local, weight, valid, rng = ggx.ggx_sample(
            scene.bsdf.roughness, scene.bsdf.eta, wi_local, rng,
            active=mask, mitsuba_comparable=settings.mitsuba_comparable,
        )
        d_bsdf = math3.to_world(fx, fy, fz, wo_local)
    else:  # 'null' pass-through boundary (reference: Bsdf.h:6-15)
        weight = jnp.ones(wi_local.shape[:-1], jnp.float32)
        valid = jnp.ones(wi_local.shape[:-1], bool)
        d_bsdf = d
    ok = jnp.logical_and(mask, valid)
    o_out = jnp.where(
        mask[..., None],
        jnp.where(ok[..., None], o_bound + d_bsdf * EPSILON, o_bound),
        o_bound,
    )
    d_out = jnp.where(ok[..., None], d_bsdf, d)
    tput_out = jnp.where(ok[..., None], tput * weight[..., None], tput)
    return o_out, d_out, tput_out, rng


#: march-iteration cap (reference: max_iterations, Medium.h:62 — the
#: reference uses 100000; expected march length is ~2·extent/min_step
#: iterations, so 4096 is already far past any non-degenerate path)
_VB_MAX_ITERS = 4096


def variable_boundary_adjust(
    scene: Scene, settings: RenderSettings, o, d, isect: aabb.Isect,
    rng: RngState, active,
):
    """Stochastic density-isosurface boundary search (reference:
    HeterogeneousMediumWithVariableBoundary::intersect, Medium.h:56-107).

    From the AABB hit point, march along the ray (inward when entering,
    backward from the exit face when the origin is inside) in uniform
    random steps of expected boundary_min_step/2 until the density
    gradient magnitude exceeds boundary_threshold; the hit distance
    moves there and the (negative) density gradient becomes the shading
    normal.  A march that crosses the whole box finds no surface: the
    lane reports no hit (environment escape) with inside_volume
    flipped, exactly the reference's return-false branch.

    Deviations from the dead reference code, documented like the g<0
    phase fix: draws come from the lane's deterministic stream (the
    reference seeds a fresh sequential RNG per call — not
    shard-invariant), and the gradient normal is normalized before use
    (the reference feeds the raw finite-difference vector to a frame
    builder that assumes unit length).

    Returns (isect', rng) with updates applied only on active lanes.
    """
    med = scene.medium
    min_step = settings.boundary_min_step
    thresh = settings.boundary_threshold
    extent = med.box_max - med.box_min

    sign = jnp.where(isect.inside_volume, -1.0, 1.0)
    temp_d = sign[..., None] * d
    temp_o0 = o + d * (isect.dist + EPSILON)[..., None]
    isect2 = aabb.aabb_intersect(med.box_min, med.box_max, temp_o0, temp_d)
    consider = jnp.logical_and(
        jnp.logical_and(active, isect.hit), isect2.hit
    )

    def w2v(p):
        return (p - med.box_min) / extent

    temp_o_init = temp_o0 - (min_step + EPSILON) * temp_d
    grad0 = gradient.gradient_cd(
        med.density, w2v(temp_o_init), min_step, settings.interpolation
    )

    n = isect.dist.shape
    zero = jnp.zeros(n, jnp.float32)

    def below(grad):
        return math3.norm(grad) < thresh

    # carry: (running, iters, total, new_dist, temp_o, grad,
    #         no_hit, keep_orig, rng)
    def cond(c):
        return jnp.any(c[0])

    def body(c):
        (running, iters, total, new_dist, temp_o, grad, no_hit,
         keep_orig, rng_c) = c
        u, rng_c = next_float(rng_c, running)
        s = u * min_step
        total_n = jnp.where(running, total + s, total)
        nd = jnp.where(running, new_dist + sign * s, new_dist)
        # marched out the near side: keep the original AABB result
        ko = jnp.logical_and(running, nd < 0.0)
        keep_orig = jnp.logical_or(keep_orig, ko)
        # marched across to the far boundary: no surface on this segment
        nh = jnp.logical_and(
            running,
            jnp.logical_and(jnp.logical_not(ko), total_n > isect2.dist),
        )
        no_hit = jnp.logical_or(no_hit, nh)
        running = jnp.logical_and(
            running, jnp.logical_not(jnp.logical_or(ko, nh))
        )
        temp_o = jnp.where(running[..., None], temp_o + temp_d * s[..., None],
                           temp_o)
        grad_new = gradient.gradient_cd(
            med.density, w2v(temp_o), min_step, settings.interpolation
        )
        grad = jnp.where(running[..., None], grad_new, grad)
        iters = iters + 1
        keep_orig = jnp.logical_or(
            keep_orig, jnp.logical_and(running, iters >= _VB_MAX_ITERS)
        )
        running = jnp.logical_and(
            running,
            jnp.logical_and(below(grad), iters < _VB_MAX_ITERS),
        )
        return (running, iters, total_n, nd, temp_o, grad, no_hit,
                keep_orig, rng_c)

    running0 = jnp.logical_and(consider, below(grad0))
    out = jax.lax.while_loop(
        cond, body,
        (running0, jnp.int32(0), zero, isect.dist, temp_o_init, grad0,
         jnp.zeros(n, bool), jnp.zeros(n, bool), rng),
    )
    (_, _, total, new_dist, _, grad, no_hit, keep_orig, rng) = out

    # surface found with a real march: move the hit there, normal from
    # the gradient (total == 0 keeps the AABB face normal, reference
    # Medium.h:101-104)
    found = jnp.logical_and(
        consider,
        jnp.logical_not(jnp.logical_or(no_hit, keep_orig)),
    )
    moved = jnp.logical_and(
        found, jnp.logical_and(new_dist > 0.0, total > 0.0)
    )
    g_unit = math3.normalize(grad)
    dist_out = jnp.where(moved, new_dist, isect.dist)
    normal_out = jnp.where(moved[..., None], g_unit, isect.normal)
    hit_out = jnp.logical_and(
        isect.hit, jnp.logical_not(jnp.logical_and(consider, no_hit))
    )
    inside_out = jnp.where(
        jnp.logical_and(consider, no_hit),
        jnp.logical_not(isect.inside_volume),
        isect.inside_volume,
    )
    return aabb.Isect(
        dist=dist_out, normal=normal_out, inside_volume=inside_out,
        hit=hit_out,
    ), rng


def russian_roulette(tput, alive, rng, mask):
    """Shared Russian roulette (reference: NaiveVolPTsk_kernel.cuh:75-84):
    p = min(1, max(throughput.rgb)); kill with 1-p, else divide.  Draws
    only on ``mask`` lanes.  Returns (tput, alive, killed, rng)."""
    p_survive = jnp.minimum(1.0, math3.max3(tput))
    u, rng = next_float(rng, mask)
    killed = jnp.logical_and(mask, u > p_survive)
    alive = jnp.logical_and(alive, jnp.logical_not(killed))
    survived = jnp.logical_and(mask, jnp.logical_not(killed))
    tput = jnp.where(
        survived[..., None],
        tput / jnp.maximum(p_survive, 1e-20)[..., None],
        tput,
    )
    return tput, alive, killed, rng


def bounce_step(
    scene: Scene, settings: RenderSettings, state: PathState
) -> PathState:
    """Advance every live lane by one path vertex.

    Faithful to the reference control flow
    (NaiveVolPTsk_kernel.cuh:35-86):
      miss        → radiance += throughput * Le, lane dies;
      medium event→ throughput *= albedo, direction = HG sample;
      boundary    → GGX reflect/refract (weight = G1), or — on an invalid
                    microfacet sample — continue with direction and
                    throughput unchanged from the boundary point;
      then Russian roulette on max(throughput).
    """
    med = scene.medium
    o, d, tput, rad, alive, rng = (
        state.o,
        state.d,
        state.throughput,
        state.radiance,
        state.alive,
        state.rng,
    )

    n_rays = state.n_rays + jnp.sum(alive.astype(jnp.float32))

    isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
    if settings.boundary == "variable":
        # density-isosurface boundary + gradient shading normal
        # (reference: Medium.h:56-107) — static switch, off by default
        isect, rng = variable_boundary_adjust(
            scene, settings, o, d, isect, rng, alive
        )

    # --- miss: escape to the constant environment -------------------------
    miss = jnp.logical_and(alive, jnp.logical_not(isect.hit))
    rad = jnp.where(miss[..., None], rad + tput * scene.le, rad)
    alive = jnp.logical_and(alive, isect.hit)

    # --- free flight through the medium ----------------------------------
    in_medium = jnp.logical_and(alive, isect.inside_volume)
    wres = woodcock.woodcock_track(
        med.density,
        med.box_min,
        med.box_max,
        med.scale,
        med.max_density,
        o,
        d,
        isect.dist,
        rng,
        in_medium,
        settings.interpolation,
    )
    rng = wres.rng
    scattered = wres.scattered
    boundary = jnp.logical_and(alive, jnp.logical_not(scattered))

    # --- boundary event: GGX rough dielectric ----------------------------
    o_bound = o + d * isect.dist[..., None]
    o_boundary_out, d_boundary_out, t_boundary, rng = boundary_event(
        scene, settings, isect.normal, o_bound, d, tput, rng, boundary
    )

    # --- medium event: absorb into albedo, HG scatter --------------------
    o_scat = o + d * wres.t[..., None] - d * EPSILON
    albedo = sample_albedo(scene, o_scat, settings)
    d_scat, rng = phase.sample_phase(d, med.g, rng, active=scattered)

    o = jnp.where(
        scattered[..., None],
        o_scat,
        jnp.where(boundary[..., None], o_boundary_out, o),
    )
    dnew = jnp.where(
        scattered[..., None],
        d_scat,
        jnp.where(boundary[..., None], d_boundary_out, d),
    )
    tput = jnp.where(
        scattered[..., None],
        tput * albedo,
        jnp.where(boundary[..., None], t_boundary, tput),
    )
    d = dnew

    # --- Russian roulette (reference: NaiveVolPTsk_kernel.cuh:75-84) -----
    if settings.russian_roulette:
        tput, alive, _, rng = russian_roulette(tput, alive, rng, alive)

    return PathState(
        o=o, d=d, throughput=tput, radiance=rad, alive=alive, rng=rng,
        n_rays=n_rays,
    )


def trace(
    scene: Scene, settings: RenderSettings, state: PathState
) -> PathState:
    """Run lanes to extinction: bounded `while_loop` over bounce_step.

    The bound is max_path_length (reference: Config.h PathTracingConfig);
    with Russian roulette on, lanes die long before it.
    """

    def cond(carry):
        st, bounce = carry
        return jnp.logical_and(jnp.any(st.alive), bounce < settings.max_path_length)

    def body(carry):
        st, bounce = carry
        return bounce_step(scene, settings, st), bounce + 1

    final, _ = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))
    return final


def initial_state(o, d, rng) -> PathState:
    n = o.shape[:-1]
    return PathState(
        o=o,
        d=d,
        throughput=jnp.ones(n + (3,), jnp.float32),
        radiance=jnp.zeros(n + (3,), jnp.float32),
        alive=jnp.ones(n, bool),
        rng=rng,
        n_rays=jnp.zeros((), jnp.float32),
    )
