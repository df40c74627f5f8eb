"""Pinhole camera: pose, inverse-view matrix, and batched ray generation.

Replaces the reference's glm quaternion camera + constant-memory 3x4
inverse-view upload + per-thread ray gen (reference:
implementation/src/Camera.h:16-125, implementation/src/CudaVolPath.cpp:67-85,
implementation/src/Utilities.cuh:180-213).  Here the camera is a small
pytree; ray generation is one broadcasting array program over all pixels
of a tile, jittered by the lane-parallel PCG streams.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import math3
from .rng import RngState, next_float2


class Camera(NamedTuple):
    """Camera pytree passed into jitted render functions.

    inv_view is the 3x4 view-to-world matrix: rows transform a view-space
    direction; the 4th column is the world-space position (exactly the
    constant the reference uploads, CudaVolPath.cpp:67-85).
    """

    inv_view: jnp.ndarray  # (3, 4) float32
    raster_to_view: jnp.ndarray  # (2,) = tan(fov_{x,y} * pi / 360)


def make_camera(
    res_x: int = 400,
    res_y: int = 400,
    fov_x_deg: float = 0.7,
    position=(0.0, 0.0, 100.0),
    mitsuba_comparable: bool = True,
) -> Camera:
    """Default camera at +z looking down -z (reference: Camera.h:26-42).

    fov_y is derived from fov_x by aspect ratio (Camera.h:63-67); the
    x-axis handedness flip matches the MITSUBA_COMPARABLE flag
    (Camera.h:30-34).  fov is in degrees, as in the reference
    (raster_to_view = tan(fov * pi/360), Camera.h:69-71).
    """
    fov_y_deg = (float(res_y) / float(res_x)) * fov_x_deg
    r2v = np.array(
        [
            math.tan(fov_x_deg * math.pi / 360.0),
            math.tan(fov_y_deg * math.pi / 360.0),
        ],
        dtype=np.float32,
    )
    right_x = 1.0 if mitsuba_comparable else -1.0
    # Rows of the view-to-world transform; translation in the last column.
    inv_view = np.array(
        [
            [right_x, 0.0, 0.0, position[0]],
            [0.0, -1.0, 0.0, position[1]],
            [0.0, 0.0, -1.0, position[2]],
        ],
        dtype=np.float32,
    )
    return Camera(inv_view=jnp.asarray(inv_view), raster_to_view=jnp.asarray(r2v))


def make_camera_look_at(
    eye, center, up, res_x: int, res_y: int, fov_x_deg: float
) -> Camera:
    """Look-at constructor (reference: Camera.h lookAt:107-122)."""
    eye = np.asarray(eye, np.float32)
    forward = np.asarray(center, np.float32) - eye
    forward = forward / np.linalg.norm(forward)
    right = np.cross(forward, np.asarray(up, np.float32))
    right = right / np.linalg.norm(right)
    new_up = np.cross(right, forward)
    new_up = new_up / np.linalg.norm(new_up)
    fov_y_deg = (float(res_y) / float(res_x)) * fov_x_deg
    r2v = np.array(
        [
            math.tan(fov_x_deg * math.pi / 360.0),
            math.tan(fov_y_deg * math.pi / 360.0),
        ],
        dtype=np.float32,
    )
    # View-to-world columns are (right, -new_up, forward, eye): rays are
    # generated as d_view = (x, y, 1) with raster y growing downward
    # (generate_rays), so the z column is the viewing direction and the
    # y column is negated — for the default pose (eye +z looking at the
    # origin) this reproduces make_camera's matrix exactly.
    inv_view = np.stack(
        [
            np.array([right[0], -new_up[0], forward[0], eye[0]], np.float32),
            np.array([right[1], -new_up[1], forward[1], eye[1]], np.float32),
            np.array([right[2], -new_up[2], forward[2], eye[2]], np.float32),
        ]
    )
    return Camera(inv_view=jnp.asarray(inv_view), raster_to_view=jnp.asarray(r2v))


def generate_rays(
    camera: Camera,
    pixel_xy: jnp.ndarray,  # (..., 2) float32 pixel coordinates (incl. tile offset)
    full_resolution: Tuple[int, int],
    rng: RngState,
    active=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, RngState]:
    """Jittered camera rays for a batch of pixel coordinates.

    Mirrors indexToCameraRay (reference: Utilities.cuh:208-213): NDC from
    the full-image resolution, scale by tan(fov/2), rotate by the
    view-to-world matrix.  Returns (origins, directions, rng).
    """
    u1, u2, rng = next_float2(rng, active)
    jitter = jnp.stack([u1, u2], axis=-1)
    res = jnp.asarray(full_resolution, jnp.float32)
    raster = ((pixel_xy + jitter) * 2.0 / res) - 1.0
    raster = raster * camera.raster_to_view

    rot = camera.inv_view[:, :3]  # (3, 3) rows
    trans = camera.inv_view[:, 3]  # (3,) world position
    d_view = math3.vec3(raster[..., 0], raster[..., 1], jnp.ones(raster.shape[:-1]))
    d_view = math3.normalize(d_view)
    # full f32: a GPU may run a default-precision f32 contraction in
    # TF32 (~3 digits), coarser than neighbouring pixel directions at
    # narrow fields of view (1e-4 rad apart at fov 0.7 deg, 512 px)
    d_world = jnp.einsum(
        "ij,...j->...i", rot, d_view, precision=jax.lax.Precision.HIGHEST
    )
    o_world = jnp.broadcast_to(trans, d_world.shape)
    return o_world, d_world, rng
