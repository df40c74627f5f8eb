"""Dense voxel-grid containers and batched samplers.

Array replacement for the reference's cudaArray 3-D textures and
manual trilinear path (reference: implementation/src/Volume.h:32-114,
implementation/src/RenderKernelLauncher.cu:5-65,
implementation/src/CudaVolPath.cpp:118-186).  Grids are plain (Z, Y, X[,C])
float32 arrays resident in HBM; sampling is an 8-tap gather expressed as a
single flat `jnp.take`, which XLA fuses into the surrounding wavefront.
The x-fastest linear layout matches the reference's arrays, so loaders can
feed either renderer from the same bytes.

Interpolation modes mirror the reference's MITSUBA_COMPARABLE switch:
  - 'trilinear': manual 8-tap lerp (Volume.h:50-65, the default build);
  - 'nearest'  : truncating-int point fetch (Volume.h:67 int() casts).
Out-of-range taps clamp, matching cudaAddressModeClamp
(CudaVolPath.cpp:176-179).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp


class Grid(NamedTuple):
    """A dense voxel grid.

    data: (Z, Y, X) for scalar fields or (Z, Y, X, C) for vector fields,
    float32, x-fastest in memory like the reference's linear arrays.
    """

    data: jnp.ndarray

    @property
    def resolution(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) — matches the reference's uint3 grid_resolution."""
        z, y, x = self.data.shape[:3]
        return (x, y, z)

    @property
    def channels(self) -> int:
        return 1 if self.data.ndim == 3 else self.data.shape[3]


def volume_to_grid(grid_shape_zyx, p01: jnp.ndarray) -> jnp.ndarray:
    """[0,1]^3 normalized coords → voxel coords, scaled by (res - 1)
    (reference: Volume.h:40-45 volumeToGrid)."""
    nz, ny, nx = grid_shape_zyx[:3]
    scale = jnp.asarray(
        [nx - 1, ny - 1, nz - 1], dtype=jnp.float32
    )
    return p01 * scale


def _flat_gather(data: jnp.ndarray, ix, iy, iz):
    """Clamped integer-tap gather from a (Z, Y, X[,C]) grid via flat take."""
    nz, ny, nx = data.shape[:3]
    ix = jnp.clip(ix, 0, nx - 1)
    iy = jnp.clip(iy, 0, ny - 1)
    iz = jnp.clip(iz, 0, nz - 1)
    flat_idx = (iz * ny + iy) * nx + ix
    if data.ndim == 3:
        return jnp.take(data.reshape(-1), flat_idx, axis=0)
    return jnp.take(data.reshape(-1, data.shape[3]), flat_idx, axis=0)


def sample_nearest(grid: Grid, p01: jnp.ndarray) -> jnp.ndarray:
    """Point sampling with int() truncation semantics (Volume.h:67)."""
    coord = volume_to_grid(grid.data.shape, p01)
    idx = coord.astype(jnp.int32)  # truncation toward zero, like int()
    return _flat_gather(grid.data, idx[..., 0], idx[..., 1], idx[..., 2])


def sample_trilinear(grid: Grid, p01: jnp.ndarray) -> jnp.ndarray:
    """Manual 8-tap trilinear interpolation (Volume.h:50-65).

    Returns shape (...,) for scalar grids, (..., C) for vector grids.
    """
    coord = volume_to_grid(grid.data.shape, p01)
    c0 = jnp.floor(coord)
    i0 = c0.astype(jnp.int32)
    f = coord - c0
    x1, y1, z1 = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    if grid.data.ndim == 4:
        fx = fx[..., None]
        fy = fy[..., None]
        fz = fz[..., None]

    d000 = _flat_gather(grid.data, x1, y1, z1)
    d001 = _flat_gather(grid.data, x1 + 1, y1, z1)
    d010 = _flat_gather(grid.data, x1, y1 + 1, z1)
    d011 = _flat_gather(grid.data, x1 + 1, y1 + 1, z1)
    d100 = _flat_gather(grid.data, x1, y1, z1 + 1)
    d101 = _flat_gather(grid.data, x1 + 1, y1, z1 + 1)
    d110 = _flat_gather(grid.data, x1, y1 + 1, z1 + 1)
    d111 = _flat_gather(grid.data, x1 + 1, y1 + 1, z1 + 1)

    _fx, _fy, _fz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    return (
        ((d000 * _fx + d001 * fx) * _fy + (d010 * _fx + d011 * fx) * fy) * _fz
        + ((d100 * _fx + d101 * fx) * _fy + (d110 * _fx + d111 * fx) * fy) * fz
    )


def sample(grid: Grid, p01: jnp.ndarray, interpolation: str = "trilinear"):
    if interpolation == "trilinear":
        return sample_trilinear(grid, p01)
    if interpolation == "nearest":
        return sample_nearest(grid, p01)
    raise ValueError(f"unknown interpolation {interpolation!r}")
