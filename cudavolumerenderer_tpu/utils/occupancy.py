"""Pool sizing + device-memory guard: the wavefront analog of the
reference's occupancy auto-tuning and device-capability validation.

The reference picks launch geometry with cudaOccupancyMaxPotentialBlockSize
(reference: implementation/src/Occupancy.cuh:24-70) and validates the
volume against device memory, falling back to zero-copy host textures when
the albedo texture would exceed 80% of global memory (reference:
implementation/src/Config.h:119-159).  Here the corresponding knobs are

  * the wavefront pool width (``n_lanes``) — the persistent-thread grid
    size analog, bounded below by device utilization and above by device
    memory and by the amount of work actually available; and
  * the fused-table layout — a giant full-per-voxel-albedo grid cannot
    afford the (V, 4) fused albedo+density copy, so the renderer degrades
    to a split layout (flat density table + direct albedo taps), and
    refuses with a clear error when even the raw grids cannot fit.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

#: budget assumed on the CPU backend, whose devices report no memory
#: stats: host RAM is not a device budget, and a fixed value keeps pool
#: sizing and the split-table plan reproducible across CPU hosts
CPU_BUDGET_BYTES = 16 << 30

#: never spend more than this fraction of the budget on per-lane
#: wavefront state (the rest is grids, tables, and XLA scratch)
_LANE_STATE_FRACTION = 0.25

#: bytes of SoA state per wavefront lane: fastSK packs to (N, 27) f32
#: (models/fast.py _pack) and the cascade keeps at most two pools live;
#: round up generously for fusion scratch
_BYTES_PER_LANE = 27 * 4 * 4

#: build the (V, 4) fused albedo+density table only while it stays under
#: this fraction of the budget; above it, split layout (Config.h's 80%
#: threshold, applied to the fused copy we'd be adding)
_FUSED_TABLE_FRACTION = 0.30


def device_memory_budget(device=None) -> int:
    """Memory in bytes this process may use on `device` (default: the
    first JAX device) — the reference's deviceProp totalGlobalMem
    lookup (Config.h:119-130).  Read from the allocator's bytes_limit;
    the CPU backend gets CPU_BUDGET_BYTES.  Any other device that
    reports no limit is an error: no size is assumed for it."""
    if device is None:
        import jax

        device = jax.devices()[0]
    stats = device.memory_stats()
    if stats:
        limit = stats.get("bytes_limit") or stats.get(
            "bytes_reservable_limit"
        )
        if limit:
            return int(limit)
    if device.platform == "cpu":
        return CPU_BUDGET_BYTES
    raise RuntimeError(
        f"{device.platform} device {device.device_kind!r} reports no "
        "memory limit (memory_stats()['bytes_limit']); cannot size "
        "the wavefront pool or plan the albedo table for it"
    )


def grid_bytes(grid_shape_zyx: Tuple[int, ...], channels: int = 1) -> int:
    nz, ny, nx = grid_shape_zyx[:3]
    return nz * ny * nx * channels * 4


def plan_albedo_table(
    grid_shape_zyx: Tuple[int, ...],
    budget: Optional[int] = None,
) -> str:
    """'fused' | 'split' for a full per-voxel-albedo scene: whether the
    (V, 4) fused albedo+density copy fits comfortably in device memory.

    Raises MemoryError when even the raw density+albedo grids cannot fit
    (the reference prints "NOT ENOUGH MEMORY SPACE ON THE DEVICE" and
    falls back to zero-copy host memory, Config.h:135-148; this renderer
    has no zero-copy path, so we fail early with advice instead of OOMing in
    the middle of a render)."""
    budget = budget or device_memory_budget()
    fused = grid_bytes(grid_shape_zyx, 4)
    raw = grid_bytes(grid_shape_zyx, 1) + grid_bytes(grid_shape_zyx, 4)
    if raw > 0.8 * budget:
        raise MemoryError(
            f"scene grids need {raw / 2**30:.1f} GiB "
            f"(> 80% of the {budget / 2**30:.1f} GiB device budget); "
            "a full per-voxel albedo at this resolution cannot fit on "
            "one chip — use a constant or density-affine albedo (stored "
            "as coefficients, not a grid), shard the scene, or reduce "
            "the grid resolution"
        )
    if fused > _FUSED_TABLE_FRACTION * budget:
        return "split"
    return "fused"


def pick_n_lanes(
    n_pix: int,
    spp: int,
    grid_shape_zyx: Tuple[int, ...] = (1, 1, 1),
    budget: Optional[int] = None,
    lo: int = 1 << 12,
    hi: int = 1 << 17,
) -> int:
    """Wavefront pool width for the queue-fed schedulers (regeneration /
    streaming / fastQ) — the cudaOccupancyMaxPotentialBlockSize analog
    (Occupancy.cuh:24-70): as wide as the work and the memory budget
    allow, clamped to [lo, hi], rounded to a multiple of 256 lanes
    (whole 256-lane blocks, as in fast._cascade_widths).

    * never wider than the work: n_paths lanes render everything in one
      regeneration, wider only burns memory;
    * never more than _LANE_STATE_FRACTION of free device memory after
      the grids;
    * at least `lo` so the device stays busy.
    """
    budget = budget or device_memory_budget()
    n_paths = n_pix * max(spp, 1)
    grids = grid_bytes(grid_shape_zyx, 5)  # density + albedo, worst case
    free = max(budget - grids, budget // 8)
    mem_cap = int(free * _LANE_STATE_FRACTION) // _BYTES_PER_LANE
    lanes = min(n_paths, mem_cap, hi)
    lanes = max(lanes, min(lo, n_paths))
    return max(256, (lanes // 256) * 256)


def validate_pool(n_lanes: int, grid_shape_zyx, budget=None) -> None:
    """Warn-level guard for explicit --n-lanes choices (the reference
    prints configuration warnings rather than failing, Config.h:122-133).
    """
    budget = budget or device_memory_budget()
    state = n_lanes * _BYTES_PER_LANE
    grids = grid_bytes(grid_shape_zyx, 5)
    if state + grids > budget:
        import warnings

        warnings.warn(
            f"wavefront state ({state / 2**30:.2f} GiB at {n_lanes} "
            f"lanes) plus grids ({grids / 2**30:.2f} GiB) exceeds the "
            f"device budget ({budget / 2**30:.1f} GiB); reduce "
            "--n-lanes or the grid resolution",
            stacklevel=2,
        )


def autotune_report(n_pix, spp, grid_shape_zyx, budget=None) -> str:
    """Human-readable line mirroring the reference's occupancy printout
    (RenderKernelLauncher.cu:318-324)."""
    budget = budget or device_memory_budget()
    lanes = pick_n_lanes(n_pix, spp, grid_shape_zyx, budget)
    return (
        f"[cvr] occupancy: pool {lanes} lanes "
        f"({lanes * _BYTES_PER_LANE / 2**20:.1f} MiB state), "
        f"budget {budget / 2**30:.1f} GiB, "
        f"work {n_pix * spp} paths"
    )
