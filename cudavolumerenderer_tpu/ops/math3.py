"""Small-vector math on batched (..., 3) arrays.

Replaces the reference's float3/float4 helper overloads and local-frame
utilities (reference: implementation/src/CVRMath.h, the Frame used in
NaiveVolPTsk_kernel.cuh:55-57, and generateLocalBasis in
implementation/src/HG.h:11-24) with broadcasting JAX ops: every function
acts on arbitrarily batched stacks of 3-vectors so a whole ray wavefront is
one elementwise array program.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..constants import EPSILON


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def norm(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def normalize(a: jnp.ndarray) -> jnp.ndarray:
    return a / jnp.maximum(norm(a), 1e-20)[..., None]


def vec3(x, y, z) -> jnp.ndarray:
    return jnp.stack(
        jnp.broadcast_arrays(
            jnp.asarray(x, jnp.float32),
            jnp.asarray(y, jnp.float32),
            jnp.asarray(z, jnp.float32),
        ),
        axis=-1,
    )


def max3(a: jnp.ndarray) -> jnp.ndarray:
    """Componentwise max over the last axis (reference: CVRMath.h fmaxf3)."""
    return jnp.max(a, axis=-1)


def frame_from_z(z: jnp.ndarray):
    """Orthonormal frame (x, y, z) around normal ``z``.

    Matches Frame::setFromZ (reference: implementation/src/CVRMath.h:68-74):
    picks a helper axis, y = normalize(z × helper), x = y × z.  Returns
    (x, y, z_normalized), each with the batch shape of ``z``.
    """
    zn = normalize(z)
    helper_is_y = jnp.abs(zn[..., 0]) > 0.99
    helper = jnp.where(
        helper_is_y[..., None],
        vec3(0.0, 1.0, 0.0),
        vec3(1.0, 0.0, 0.0),
    )
    y = normalize(cross(zn, helper))
    x = cross(y, zn)
    return x, y, zn


def to_local(t, b, n, v):
    """World → local (z = n) coordinates."""
    return jnp.stack([dot(v, t), dot(v, b), dot(v, n)], axis=-1)


def to_world(t, b, n, v):
    """Local (z = n) → world coordinates."""
    return (
        v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n
    )


def local_basis(d: jnp.ndarray):
    """Basis (v1, v2) around direction ``d`` matching the reference's
    generateLocalBasis (reference: implementation/src/HG.h:11-17), with an
    epsilon guard for the (x, z) ≈ 0 pole the reference leaves unguarded."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    inv_n1 = 1.0 / jnp.sqrt(jnp.maximum(dx * dx + dz * dz, 1e-12))
    v1 = vec3(dz * inv_n1, jnp.zeros_like(dx), -dx * inv_n1)
    v2 = cross(d, v1)
    return v1, v2


def spherical_direction(sin_theta, cos_theta, phi, x, y, z):
    """Direction from spherical coords in basis (x, y, z)
    (reference: implementation/src/HG.h:19-24)."""
    return (
        (sin_theta * jnp.cos(phi))[..., None] * x
        + (sin_theta * jnp.sin(phi))[..., None] * y
        + cos_theta[..., None] * z
    )


def reflect_about(ndotwi, wi, wh):
    """Mirror ``wi`` about half-vector ``wh``
    (reference: implementation/src/GGX.h:40-43)."""
    return 2.0 * ndotwi[..., None] * wh - wi


def offset_ray(o, d, eps: float = EPSILON):
    """Nudge origin along direction to escape self-intersection."""
    return o + d * eps
