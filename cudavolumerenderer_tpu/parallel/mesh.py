"""Device mesh construction for multi-chip / multi-host rendering.

Replaces the reference's single-GPU execution model with jax.sharding
(SURVEY.md §2.8 mapping): the first-class parallel axis is 'rays' — data
parallelism over paths/samples — with voxel grids replicated and images /
gradients reduced with psum over the device interconnect (NVLink
within a host).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    n_devices: Optional[int] = None, axis_name: str = "rays"
) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def initialize_distributed(**kwargs) -> None:
    """Multi-host entry (jax.distributed.initialize); call once per host
    before building meshes that span hosts."""
    jax.distributed.initialize(**kwargs)
