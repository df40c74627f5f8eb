"""Scene data model: pytrees consumed by the jitted render functions.

Replaces the reference's host/device scene classes (reference:
implementation/src/Scene.h:19-54, implementation/src/Medium.h:111-191,
implementation/src/Bsdf.h:17-30) with immutable NamedTuple pytrees.  All
numeric fields are traced JAX arrays so one compiled renderer serves every
scene of the same grid shape; everything shape-like or branch-like lives in
the static `RenderSettings` (JAX specializes via jit instead of the
reference's template-instantiation matrix, Defines.h:93-118).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..ops.grid import Grid


class Medium(NamedTuple):
    """Heterogeneous participating medium
    (reference: implementation/src/Medium.h:111-158)."""

    density: Grid  # (Z, Y, X) float32
    albedo: Grid  # (Z, Y, X, 4) float32
    box_min: jnp.ndarray  # (3,)
    box_max: jnp.ndarray  # (3,)
    scale: jnp.ndarray  # () sigma_t multiplier
    max_density: jnp.ndarray  # ()
    g: jnp.ndarray  # () HG anisotropy (reference default 0, Volume.h:20)
    #: (2, 3) [A; B] when albedo == A * density + B voxelwise (detected at
    #: build time), else None.  Lets the fastSK fused table stay a flat
    #: density-only vector — one 4-byte gather per tap instead of a
    #: 16-byte row, and the table shrinks 4x.  Both the medical-class synthetic and the MHD red-channel
    #: albedo convention (scripts/convert-mhd/mhd_to_vdb.py:61-74) are
    #: affine in density.
    #:
    #: NOTE: the coefficients are fit against the build-time density.
    #: Replacing `density` on an existing Medium (e.g. in an inverse
    #: driver) invalidates them — use `with_density`, which clears the
    #: fit, instead of a raw `_replace(density=...)`.
    albedo_affine: Optional[jnp.ndarray] = None

    def with_density(self, density_zyx) -> "Medium":
        """Replace the density grid, clearing the build-time affine-albedo
        fit (which is only valid against the density it was fit to)."""
        return self._replace(
            density=Grid(data=jnp.asarray(density_zyx)),
            albedo_affine=None,
        )


class Bsdf(NamedTuple):
    """Rough-dielectric boundary parameters
    (reference: implementation/src/Bsdf.h:17-30).

    eta = int_ior / ext_ior (reference default 1.05 / 1.01)."""

    roughness: jnp.ndarray  # (2,)
    eta: jnp.ndarray  # ()


class Scene(NamedTuple):
    """Medium + boundary + environment emission.

    The reference's only light is a constant white environment
    (Le == (1,1,1,1), Medium.h:174-177); we keep it as a traced parameter.
    """

    medium: Medium
    bsdf: Bsdf
    le: jnp.ndarray  # (3,) environment radiance


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static (compile-time) rendering switches.

    Collapses the reference's Defines.h compile-time knobs
    (MITSUBA_COMPARABLE, RUSSIAN_ROULETTE, max_path_length, filter mode)
    into one hashable config used as a jit static argument.
    """

    mitsuba_comparable: bool = True
    russian_roulette: bool = True
    max_path_length: int = 1000
    #: 'ggx' — reference boundary BSDF; 'null' — pass-through boundary
    #: (reference: the BSDF base struct in Bsdf.h:6-15), used for
    #: white-furnace oracles.
    bsdf_kind: str = "ggx"
    #: grid filter: 'trilinear' under mitsuba-comparable, else 'nearest'
    #: (reference: Volume.h:50-69, CudaVolPath.cpp:171-175).
    interpolation: str = "trilinear"
    #: count traced rays (reference: RAYS_STATISTICS, Defines.h:49-50).
    rays_statistics: bool = True
    #: medium boundary model: 'aabb' — the box faces (every reference
    #: factory configuration); 'variable' — the stochastic
    #: density-isosurface march of HeterogeneousMediumWithVariableBoundary
    #: (reference: Medium.h:55-107 + Gradient.h, present in source but
    #: never instantiated there): the boundary event fires where the
    #: density gradient magnitude first exceeds boundary_threshold, with
    #: the (negative) density gradient as shading normal.  Supported by
    #: the integrator-family schedulers (naive/regeneration/streaming/
    #: sorting/MK); fastSK's fused tables keep the AABB boundary.
    boundary: str = "aabb"
    #: gradient-magnitude threshold for the variable boundary
    #: (reference: density_threshold, Medium.h:17)
    boundary_threshold: float = 1e-8
    #: expected march step, world units (reference: MIN_STEP uniform
    #: step scale, Medium.h:87)
    boundary_min_step: float = 0.1

    @classmethod
    def from_flags(cls, mitsuba_comparable: bool = True, **kw) -> "RenderSettings":
        interp = "trilinear" if mitsuba_comparable else "nearest"
        return cls(
            mitsuba_comparable=mitsuba_comparable, interpolation=interp, **kw
        )


def make_medium(
    density_zyx: np.ndarray,
    albedo_zyx: np.ndarray,
    box_min=(-0.5, -0.5, -0.5),
    box_max=(0.5, 0.5, 0.5),
    scale: float = 1.0,
    max_density: float | None = None,
    g: float = 0.0,
) -> Medium:
    """Assemble a Medium from volumes in x-fastest (Z, Y, X[,C]) layout.

    Accepts numpy or jax arrays (jax arrays pass through without a host
    round-trip — required for device-generated giant grids).  A scalar or
    (3,) albedo becomes a constant (1, 1, 1, 4) grid; the fastSK fused
    table then stays density-only, which is what makes the BASELINE
    1024^3 sparse class fit in HBM.
    """
    if not isinstance(density_zyx, jnp.ndarray):
        density_zyx = np.asarray(density_zyx, np.float32)
    if np.ndim(albedo_zyx) <= 1:  # constant albedo
        albedo_zyx = np.broadcast_to(
            np.asarray(albedo_zyx, np.float32).reshape(1, 1, 1, -1),
            (1, 1, 1, 3),
        ).copy()
    if not isinstance(albedo_zyx, jnp.ndarray):
        albedo_zyx = np.asarray(albedo_zyx, np.float32)
    if albedo_zyx.ndim == 3:
        albedo_zyx = albedo_zyx[..., None]
    if albedo_zyx.shape[-1] == 3:
        xp = jnp if isinstance(albedo_zyx, jnp.ndarray) else np
        albedo_zyx = xp.concatenate(
            [
                albedo_zyx,
                xp.ones(albedo_zyx.shape[:-1] + (1,), np.float32),
            ],
            axis=-1,
        )
    if max_density is None:
        max_density = float(density_zyx.max())
    affine = None
    if (
        isinstance(density_zyx, np.ndarray)
        and isinstance(albedo_zyx, np.ndarray)
        and albedo_zyx.shape[:3] == density_zyx.shape
    ):
        affine = _fit_albedo_affine(density_zyx, albedo_zyx)
    return Medium(
        albedo_affine=None if affine is None else jnp.asarray(affine),
        density=Grid(data=jnp.asarray(density_zyx)),
        albedo=Grid(data=jnp.asarray(albedo_zyx)),
        box_min=jnp.asarray(box_min, jnp.float32),
        box_max=jnp.asarray(box_max, jnp.float32),
        scale=jnp.asarray(scale, jnp.float32),
        max_density=jnp.asarray(max_density, jnp.float32),
        g=jnp.asarray(g, jnp.float32),
    )


def _fit_albedo_affine(
    density: np.ndarray, albedo: np.ndarray
) -> Optional[np.ndarray]:
    """Return (2, 3) [A; B] with albedo.rgb == A*density + B (exactly,
    within float32 rounding) or None.  Host-side, build-time only."""
    d = density.reshape(-1).astype(np.float32)
    a = albedo[..., :3].reshape(-1, 3).astype(np.float32)
    i_min, i_max = int(d.argmin()), int(d.argmax())
    d0, d1 = float(d[i_min]), float(d[i_max])
    if d1 - d0 < 1e-12:
        return None
    A = (a[i_max] - a[i_min]) / np.float32(d1 - d0)
    B = a[i_min] - A * np.float32(d0)
    # validate in slabs with early exit: a full-grid (N, 3) reconstruction
    # temp would cost ~12 GB host RAM at 1024^3 with per-voxel albedo
    chunk = 1 << 24
    for lo in range(0, d.shape[0], chunk):
        hi = min(lo + chunk, d.shape[0])
        if not np.allclose(
            a[lo:hi], d[lo:hi, None] * A + B, atol=2e-6, rtol=0.0
        ):
            return None
    return np.stack([A, B]).astype(np.float32)


def make_scene(
    medium: Medium,
    roughness: Tuple[float, float] = (0.1, 0.1),
    int_ior: float = 1.05,
    ext_ior: float = 1.01,
    le=(1.0, 1.0, 1.0),
) -> Scene:
    """Scene with the reference's default boundary and environment
    (reference: Bsdf.h:20-23, Medium.h:174-177)."""
    return Scene(
        medium=medium,
        bsdf=Bsdf(
            roughness=jnp.asarray(roughness, jnp.float32),
            eta=jnp.asarray(int_ior / ext_ior, jnp.float32),
        ),
        le=jnp.asarray(le, jnp.float32),
    )
