"""Axis-aligned bounding box intersection and transforms, batched.

Re-expresses the reference's AABB slab test (reference:
implementation/src/Geometry.h:55-92) as a branchless array program: the
whole ray wavefront is intersected in one shot as elementwise array code, with the
reference's exact tie-breaking rules (distance selection, face-normal
pick order, inside/outside classification) reproduced via where-cascades
so images stay comparable.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..constants import EPSILON
from . import math3


class Isect(NamedTuple):
    """Batched intersection record (reference: implementation/src/Ray.h:60-68)."""

    dist: jnp.ndarray  # (...,) distance to the chosen slab plane
    normal: jnp.ndarray  # (..., 3) outward face normal of that plane
    inside_volume: jnp.ndarray  # (...,) bool — ray origin inside the box
    hit: jnp.ndarray  # (...,) bool


def aabb_transform(box_min: jnp.ndarray, box_max: jnp.ndarray, p: jnp.ndarray):
    """World point → normalized [0,1]^3 box coordinates
    (reference: implementation/src/Geometry.h:51-53)."""
    return (p - box_min) / (box_max - box_min)


def aabb_intersect(
    box_min: jnp.ndarray, box_max: jnp.ndarray, o: jnp.ndarray, d: jnp.ndarray
) -> Isect:
    """Slab test with the reference's semantics.

    - dist = largest entering t if > EPSILON (origin outside), else the
      exit t (origin inside the box);
    - normal = the axis plane whose t equals dist, tested in the fixed
      order +x,+y,+z,-x,-y,-z (ttop before tbot);
    - inside_volume = normal · d > 0 (ray exits through that plane);
    - hit = (exit > enter) and dist > 0.
    """
    inv_r = 1.0 / d
    tbot = inv_r * (box_min - o)
    ttop = inv_r * (box_max - o)

    tmin = jnp.minimum(ttop, tbot)
    tmax = jnp.maximum(ttop, tbot)

    largest_tmin = jnp.max(tmin, axis=-1)
    smallest_tmax = jnp.min(tmax, axis=-1)

    dist = jnp.where(largest_tmin > EPSILON, largest_tmin, smallest_tmax)

    # Face-normal pick, reproducing the reference's if/else-if chain order.
    candidates = [
        (ttop[..., 0], math3.vec3(1.0, 0.0, 0.0)),
        (ttop[..., 1], math3.vec3(0.0, 1.0, 0.0)),
        (ttop[..., 2], math3.vec3(0.0, 0.0, 1.0)),
        (tbot[..., 0], math3.vec3(-1.0, 0.0, 0.0)),
        (tbot[..., 1], math3.vec3(0.0, -1.0, 0.0)),
        (tbot[..., 2], math3.vec3(0.0, 0.0, -1.0)),
    ]
    normal = jnp.zeros_like(o)
    taken = jnp.zeros(dist.shape, dtype=bool)
    for t_plane, n_plane in candidates:
        match = jnp.logical_and(~taken, dist == t_plane)
        normal = jnp.where(match[..., None], n_plane, normal)
        taken = jnp.logical_or(taken, match)

    inside = math3.dot(normal, d) > 0.0
    hit = jnp.logical_and(smallest_tmax > largest_tmin, dist > 0.0)
    return Isect(dist=dist, normal=normal, inside_volume=inside, hit=hit)
