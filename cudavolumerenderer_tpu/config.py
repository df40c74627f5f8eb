"""Runtime configuration: one dataclass replacing the reference's two-level
config (boost::program_options runtime flags + Defines.h compile-time
knobs; reference: implementation/src/Config.h:35-248,
implementation/src/ConfigParser.cpp:10-165).  JAX specializes via jit, so
everything is a runtime field here.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import os
from typing import Optional, Tuple

from .scene.types import RenderSettings


class Kernel(enum.Enum):
    """Scheduling strategies (reference: Config.h:87-95 Kernel enum)."""

    NAIVE_SK = "naiveSK"
    NAIVE_MK = "naiveMK"
    REGENERATION_SK = "regenerationSK"
    STREAMING_MK = "streamingMK"
    STREAMING_SK = "streamingSK"
    SORTING_SK = "sortingSK"
    #: beyond-reference wavefront scheduler (models/fast.py): lane-pinned
    #: pixels, fused albedo+density gather, stochastic trilinear filtering
    FAST_SK = "fastSK"
    #: queue-fed fast wavefront with deferred splat flush (models/fastq.py)
    FAST_Q = "fastQ"

    @classmethod
    def from_name(cls, name: str) -> "Kernel":
        for k in cls:
            if k.value.lower() == name.lower():
                return k
        raise ValueError(
            f"unknown kernel {name!r}; choose from "
            f"{[k.value for k in cls]}"
        )


class Algorithm(enum.Enum):
    """Only one algorithm exists (reference: Config.h:82-85)."""

    CUDA_VOL_PATH = "cudaVolPath"


class SceneType(enum.Enum):
    AUTO = "Auto"
    MITSUBA_XML = "MitsubaXml"
    VDB = "Vdb"
    RAW = "Raw"
    MHD = "Mhd"
    NPZ = "Npz"

    @classmethod
    def detect(cls, scene_path: str) -> "SceneType":
        """Extension-based auto-detection
        (reference: ConfigParser.cpp:79-97, extended with mhd/npz)."""
        ext = os.path.splitext(scene_path)[1].lower()
        if ext == ".xml":
            return cls.MITSUBA_XML
        if ext == ".vdb":
            return cls.VDB
        if ext in (".mhd", ".mha"):
            return cls.MHD
        if ext == ".npz":
            return cls.NPZ
        return cls.RAW


@dataclasses.dataclass
class TilingConfig:
    """Image tiling (reference: Config.h:61-78): tile_dim = ceil(res / n)."""

    resolution: Tuple[int, int] = (1024, 1024)
    n_tiles: Tuple[int, int] = (1, 1)

    @property
    def tile_dim(self) -> Tuple[int, int]:
        return (
            math.ceil(self.resolution[0] / self.n_tiles[0]),
            math.ceil(self.resolution[1] / self.n_tiles[1]),
        )


@dataclasses.dataclass
class Config:
    """Full run configuration (CLI mirror of ConfigParser.cpp:10-67)."""

    scene_file: Optional[str] = None
    scene_type: SceneType = SceneType.AUTO
    algorithm: Algorithm = Algorithm.CUDA_VOL_PATH
    kernel: Kernel = Kernel.FAST_SK
    iterations: int = 20
    resolution: Tuple[int, int] = (1024, 1024)
    n_tiles: Tuple[int, int] = (1, 1)
    trials: int = 1
    interactive: bool = False  # offline progressive dumps replace GLFW
    output_name: Optional[str] = None
    seed: int = 1234
    #: wavefront pool size for regeneration/streaming schedulers
    #: (the persistent-thread grid-size analog); None = auto-tuned from
    #: the work size and device memory budget (utils/occupancy.py — the
    #: cudaOccupancyMaxPotentialBlockSize analog, Occupancy.cuh:24-70)
    n_lanes: Optional[int] = None
    #: regeneration granularity level (reference:
    #: REGENERATION_SYNCHRONIZATION_LEVEL, Defines.h:40-42): 0 = per-lane
    #: (thread), 1 = per-8-lane group (warp analog), 2 = per-1024
    #: lane row block (block analog)
    regeneration_level: int = 0
    #: samples per launch for the naive scheduler (memory bound)
    spp_per_launch: int = 4
    #: two-level (sparse-leap) tracking for fastSK/fastQ — wins on sparse
    #: or high-optical-depth scenes, loses on dense small grids
    two_level: bool = False
    #: fastSK lanes per pixel: samples run in parallel lanes instead of
    #: sequentially per lane; >1 drains the cascade sooner on scenes with
    #: deep scattering (medical-class), 1 is best for short-path scenes
    lanes_per_pixel: int = 1
    #: fastSK deferred boundary events: the GGX sampler runs once every
    #: G iterations for all pending lanes (bit-exact).  Stalled lanes
    #: waste gather rows that the amortized trig may not repay; default
    #: off, unmeasured on the GPU (ROADMAP D2).
    defer_ggx: int = 0
    #: fastSK flat-table layout: (8,8,128) brick-major (texture-locality
    #: analog for giant grids); requires grid dims divisible by the brick
    brick_major: bool = False
    #: fastSK cascade pool shrink factor: 2 tracks the lane drain curve
    #: tighter than 4; may be fractional (1.5, 1.33): finer shrink
    #: steps raise full-width occupancy at the cost of more compactions
    cascade_factor: float = 2
    #: fastSK tail pools switch to single-level (global-majorant)
    #: tracking with tail_spec speculative steps per gather: narrow
    #: pools are floored by per-gather latency, and without brick
    #: crossings every speculative step stays valid
    tail_single_level: bool = False
    #: speculative Woodcock steps per body evaluation in tail pools
    tail_spec: int = 1
    #: pool width below which spec/single-level tail modes engage
    #: (None = tail_width's default); separate from tail_width because
    #: an (N, K) speculative gather only rides the latency floor when
    #: N*K stays small
    spec_width: int = None
    #: cascade bottom pool width (smaller = deeper cascade); None =
    #: the backend's default (fast._default_min_width: a sweep on the
    #: card for the GPU, a shallow cascade on CPU).  Pool widths
    #: quantize to multiples of 256, so values below 256 are
    #: equivalent to 256 (fast._cascade_widths)
    min_width: Optional[int] = None
    #: finer tail-pool brick granularity (0 = same table as full width)
    tail_bricks: int = 0
    #: fastSK two-level probe-table size cap: pick_brick halves the
    #: brick grid until the count fits (fast.pick_brick).  Coarser
    #: bricks (512 = 8^3 grid) trade majorant tightness for fewer
    #: brick-transit rows; None = fast.py's default (65536)
    max_bricks: Optional[int] = None
    #: fastSK quantized packed density table: 32 (off), 8 or 4 bits
    #: per voxel packed into uint32 rows — shrinks the big-table gather
    #: 4-8x so more of it stays in cache.
    #: REDUCED PRECISION: acceptance-probability bias up to
    #: max_density/(2^(bits+1)-2) per tap (~3.3% at 4 bits) — coarser
    #: than the reference texture path's 9-bit interpolation weights.
    #: Ignored (forced to 32) under mitsuba_comparable settings unless
    #: allow_quantized is set.
    table_bits: int = 32
    #: explicit opt-in for quantized tables under mitsuba_comparable:
    #: keeps trilinear (stochastic) filtering and every other
    #: comparability convention, trading density precision for the
    #: smaller-table gather rate class.  Off by default so the default
    #: estimator stays full-precision.
    allow_quantized: bool = False
    settings: RenderSettings = dataclasses.field(
        default_factory=lambda: RenderSettings.from_flags(True)
    )

    @property
    def effective_table_bits(self) -> int:
        """The table precision the render actually runs at.

        Single gate shared by the production factory (make_kernel_fn)
        and the benchmark drivers, so a benched configuration is always
        reachable through the CLI: quantized tables (table_bits < 32)
        engage only when mitsuba_comparable is off OR the user passed
        the explicit --allow-quantized opt-in (which keeps trilinear
        filtering and all other comparability conventions)."""
        if self.settings.mitsuba_comparable and not self.allow_quantized:
            return 32
        return self.table_bits

    @property
    def tiling(self) -> TilingConfig:
        return TilingConfig(resolution=self.resolution, n_tiles=self.n_tiles)

    def to_string(self) -> str:
        """Default output name (reference: Config.h:237-248)."""
        return (
            f"algorithm_{self.algorithm.value}_kernel_{self.kernel.value}"
            f"_iter_{self.iterations}"
        )
