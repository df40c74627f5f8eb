"""fastSK: lane-pinned streaming wavefront (beyond-reference scheduler).

Same physics as every other scheduler, restructured so that each
wavefront iteration is a handful of wide gathers and elementwise blocks
that XLA fuses:

1. **Lane-pinned pixels** — lane i owns one pixel and renders its samples
   sequentially, accumulating into a lane-private register.  No scatter
   in the loop (the reference's atomicVectorAdd analog disappears).
2. **Fused albedo+density grid** — one (Z*Y*X, 4) table of
   (albedo.rgb, density): the tracking tap and the scatter albedo come
   from a single gather row.
3. **Stochastic trilinear filtering** — one tap drawn with probability
   equal to its trilerp weight instead of the 8-tap lerp.  For Woodcock
   tracking this is *distribution-exact*: the acceptance test thins the
   majorant Poisson process at exactly the trilinear rate.
4. **Cascade tail compaction** — the wavefront's while_loop pays full
   width per iteration even when a handful of long paths remain.  The
   render runs as a cascade of pools of shrinking width; when the
   pending-lane count fits in the next pool the state is
   argsort-compacted into it and finished lanes flush their accumulators
   to the image.  This is the wavefront form of streamingSK's block
   retirement (reference: StreamingVolPTsk_kernel.cuh block-local
   compaction).
5. **Two-level sparse-leap tracking** (`two_level=True`) — per-brick
   dilated majorants in a *separate small table* (<=64k rows x 2ch, so
   probe gathers stay cache-resident), a brick entry probes and takes
   its first Woodcock step in the same iteration, and empty bricks carry
   a Chebyshev distance-transform leap so a run of empty bricks is
   crossed in one iteration (the sparse-leap analog of the reference's
   ray-marched empty-space skips; distribution-exact because no event
   can occur in a region of zero majorant).

This is not one of the reference's six strategies; kernel name `fastSK`.
Images agree with the other schedulers statistically (same estimator
mean), not sample-for-sample (different filtering estimator).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..constants import EPSILON
from ..ops import aabb, camera as cam, phase
from ..ops.rng import RngState, make_rng, next_float, next_uint32
from ..scene.types import RenderSettings, Scene
from . import integrator

# Default brick geometry for two-level tracking: (z, y, x) voxels per
# brick.  4*4*8 = 128 voxels (matches csrc brick_pack).  pick_brick
# grows it per scene so the majorant table stays small.
BRICK = (4, 4, 8)

# Keep the brick-majorant table at or under this many rows: a (B, 2) f32
# table of 64k rows is 512 KB, small enough to stay cache-resident while
# the big density table streams past it.
_MAX_BRICKS = 65536

# Cascade geometry: pool widths shrink by _CASCADE_FACTOR down to the
# minimum pool width; a stage exits when its pending lanes fit in the
# next pool.  The bottom width depends on the backend, because the
# trade is per-iteration fixed cost against wasted lane work.  On CPU
# a deep cascade is pathological (thousands of serial narrow
# iterations: a 4 s bucky render became >300 s), so CPU keeps a
# shallow one.  The GPU value comes from a 256/1024/4096 sweep on an
# H100 (PERF.md, cascade sweep) and rests on the medical config
# alone: bucky's repeats spread too far to separate the widths.  The
# first benchmark's repeated cells are where it gets re-decided.
_CASCADE_FACTOR = 4
_MIN_WIDTH = {"cpu": 4096, "gpu": 1024}


def _default_min_width() -> int:
    """Cascade bottom width for the default JAX backend; a backend with
    no measured value is an error, not a guess."""
    backend = jax.default_backend()
    if backend not in _MIN_WIDTH:
        raise ValueError(
            f"no cascade bottom width for backend {backend!r}; "
            f"known: {sorted(_MIN_WIDTH)} (pass min_width explicitly)"
        )
    return _MIN_WIDTH[backend]


# Distance-transform iterations: empty-space leaps up to this many
# bricks are collapsed into one wavefront iteration.
_LEAP_ITERS = 6

# Narrow tail pools chain several body evaluations per while-iteration
# (one pool-wide pending count per chain instead of per evaluation).
# The chain is a rolled loop (`chain_body`): eight unrolled copies cost
# 5-8x the compile of one on an H100.  Medical at bottom 1024 on an
# H100: chain 1 0.222 s, 8 unrolled 0.203 s (302 s compile), 8 rolled
# 0.191 s (58 s compile) (PERF.md, cascade sweep).  The differentiable
# replay's cascade uses the same value.
_TAIL_CHAIN = 8
# Speculative steps per body evaluation in tail pools (1 = off).  The
# (N, K) fused-table gather can cost more than the serial latency it
# saves, so speculation stays off by default.
_TAIL_SPEC = 1
_TAIL_CHAIN_WIDTH = 16384


def chain_body(body, k: int):
    """`body` evaluated k times per call, as a rolled loop: one copy of
    the body in the compiled program whatever k is."""
    if k == 1:
        return body
    return lambda s: jax.lax.fori_loop(0, k, lambda _, c: body(c), s)


def make_fused_grid(scene: Scene, mode: str = None) -> jnp.ndarray:
    """(Z*Y*X, 4) rows of (albedo.rgb, density).

    With a constant albedo (a (1,1,1,C) grid) or an albedo that is
    affine in density (Medium.albedo_affine, detected at build time) the
    fused table collapses to a density-only flat (Z*Y*X,) vector: the
    tap gather runs on the faster 1-channel path and giant sparse scenes
    (the BASELINE 1024^3 VDB class) fit in HBM without materializing a
    per-voxel albedo.  The table must stay 1-D — reshaping a 1024^3
    array to (V, 1) sends the XLA layout assigner into a multi-hour
    compile (measured; the flat reshape compiles in under a second).

    'split' mode (HBM guard, utils/occupancy.plan_albedo_table): a full
    per-voxel albedo too big to duplicate into the fused copy also uses
    the flat density table; albedo is gathered straight from the scene
    grid at accepted taps only.  Slower (a second big-table gather per
    iteration) but saves the 16 B/voxel fused duplicate — the
    device-memory counterpart of the reference's zero-copy fallback
    (Config.h:135-148).
    """
    if (mode or _albedo_mode(scene)) != "full":
        return scene.medium.density.data.reshape(-1)
    den = scene.medium.density.data.reshape(-1, 1)
    alb = scene.medium.albedo.data[..., :3].reshape(-1, 3)
    return jnp.concatenate([alb, den], axis=-1)


#: brick-major layout brick dims (z, y, x): taps within an 8x8x128
#: brick are contiguous (32 KB) in the flat table, so the random
#: accesses of a brick transit share pages (the cudaArray/
#: texture-locality analog, CudaVolPath.cpp:118-186) — built for the
#: 1024^3 class where the row-major 4.3 GB table plateaued at
#: a few Mrays/s.  The x-extent of 128 keeps the transpose's trailing
#: dimension long: an 8^3 brick layout (trailing dim 8) hit an
#: out-of-memory tiled intermediate at 1024^3 on the previous backend.
#: The value is kept until an H100 sweep re-decides it (ROADMAP S5).
_BM_BRICK = (8, 8, 128)
# shift/mask constants derived from _BM_BRICK (all dims must be powers
# of two); tap_flat_idx uses these so a future _BM_BRICK edit cannot
# silently desynchronize the indexing from the layout
_BM_SHIFT = tuple(d.bit_length() - 1 for d in _BM_BRICK)  # (z, y, x)
_BM_MASK = tuple(d - 1 for d in _BM_BRICK)
assert all(1 << s == d for s, d in zip(_BM_SHIFT, _BM_BRICK))


def brick_major_table(density_zyx: jnp.ndarray) -> jnp.ndarray:
    """Flat density table in brick-major order ((8,8,128) bricks): one
    bandwidth-bound device-side transpose.  Grid dims must be multiples
    of the brick dims (the 1024^3 class is)."""
    nz, ny, nx = density_zyx.shape
    ez, ey, ex = _BM_BRICK
    assert nz % ez == 0 and ny % ey == 0 and nx % ex == 0
    return (
        density_zyx.reshape(nz // ez, ez, ny // ey, ey, nx // ex, ex)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(-1)
    )


def _albedo_mode(scene: Scene, allow_split: bool = False) -> str:
    """'const' | 'affine' | 'full' | 'split' — static
    (pytree-structural, plus the device-memory plan for 'split')."""
    if all(s == 1 for s in scene.medium.albedo.data.shape[:3]):
        return "const"
    if scene.medium.albedo_affine is not None:
        return "affine"
    if allow_split:
        from ..utils import occupancy

        if occupancy.plan_albedo_table(
            scene.medium.density.data.shape
        ) == "split":
            return "split"
    return "full"


def _has_const_albedo(scene: Scene) -> bool:
    return _albedo_mode(scene) == "const"


def fused_row_decode(scene: Scene, row: jnp.ndarray):
    """(rho, albedo.rgb) from fused-table gather rows (const/affine/full
    modes; 'split' gathers albedo by tap index instead — see
    render_tile's tap_albedo)."""
    mode = _albedo_mode(scene)
    if mode == "const":
        alb = scene.medium.albedo.data.reshape(-1)[:3]
        return row, jnp.broadcast_to(alb, row.shape + (3,))
    if mode == "affine":
        aff = scene.medium.albedo_affine
        return row, row[..., None] * aff[0] + aff[1]
    return row[..., -1], row[..., :3]


def pick_brick(grid_shape_zyx, max_bricks: int = _MAX_BRICKS) -> Tuple[int, int, int]:
    """Smallest brick (tightest majorants) whose brick count fits
    max_bricks.  max_bricks trades probe-table size against majorant
    tightness (fewer candidate steps): the default keeps the (B, 2)
    table small; raising it gives tighter majorants at a larger
    probe table."""
    nz, ny, nx = grid_shape_zyx
    for bz, by, bx in (
        (4, 4, 4), (4, 4, 8), (8, 8, 8), (8, 8, 16), (16, 16, 16),
        (16, 16, 32), (32, 32, 32), (32, 32, 64),
    ):
        n_bricks = -(-nz // bz) * -(-ny // by) * -(-nx // bx)
        if n_bricks <= max_bricks:
            return (bz, by, bx)
    return (64, 64, 64)


def brick_majorants(
    density_zyx: jnp.ndarray, brick: Tuple[int, int, int] = BRICK
) -> jnp.ndarray:
    """Per-brick *dilated* majorants: max over the brick's voxels plus a
    one-voxel border on the high side, so any trilinear tap reachable
    from inside the brick is covered (taps are floor(coord)..floor+1).

    Computed with reduce_window so it jits and differentiates away
    (majorants are stop-gradient by construction of the estimator).
    """
    bz, by, bx = brick
    nz, ny, nx = density_zyx.shape
    nbz, nby, nbx = -(-nz // bz), -(-ny // by), -(-nx // bx)
    # padding folded into reduce_window (an explicit jnp.pad would copy
    # the whole grid — a 4.3 GB temporary at 1024^3); the -inf pad value
    # is equivalent to the zero pad since density >= 0 and every brick
    # window contains at least one real voxel
    return jax.lax.reduce_window(
        density_zyx,
        -jnp.inf,
        jax.lax.max,
        window_dimensions=(bz + 1, by + 1, bx + 1),
        window_strides=(bz, by, bx),
        padding=(
            (0, nbz * bz + 1 - nz),
            (0, nby * by + 1 - ny),
            (0, nbx * bx + 1 - nx),
        ),
    )


def brick_chebyshev_distance(brick_major: jnp.ndarray) -> jnp.ndarray:
    """Chebyshev brick-distance to the nearest non-empty brick, exact up
    to _LEAP_ITERS and capped there.  0 for non-empty bricks."""
    big = jnp.float32(1e9)
    dist = jnp.where(brick_major > 0.0, 0.0, big)
    for _ in range(_LEAP_ITERS):
        nearest = jax.lax.reduce_window(
            dist, jnp.inf, jax.lax.min,
            window_dimensions=(3, 3, 3), window_strides=(1, 1, 1),
            padding="SAME",
        )
        dist = jnp.minimum(dist, nearest + 1.0)
    return jnp.minimum(dist, jnp.float32(_LEAP_ITERS + 1))


class FastState(NamedTuple):
    o: jnp.ndarray
    d: jnp.ndarray
    throughput: jnp.ndarray
    accum: jnp.ndarray  # (N, 3) lane-private radiance sum over finished paths
    normal: jnp.ndarray
    t: jnp.ndarray
    max_t: jnp.ndarray
    # two-level tracking extras (unused when two_level=False)
    brick_exit: jnp.ndarray  # (N,) t at which the ray leaves its brick
    inv_sig_local: jnp.ndarray  # (N,) 1/(scale*rho_max_brick)
    pix: jnp.ndarray  # (N,) int32 tile-local pixel id (travels with lane)
    slot: jnp.ndarray  # (N,) int32 lanes-per-pixel slot
    samples_done: jnp.ndarray  # (N,) int32 completed paths per lane
    bounce: jnp.ndarray  # (N,) int32 events on the current path
    alive: jnp.ndarray  # (N,) current path in flight
    tracking: jnp.ndarray
    rng: RngState
    n_rays: jnp.ndarray
    # telemetry: lane-iterations (rows) and tracking-lane occupancy
    n_rows: jnp.ndarray  # () f32 — sum over iterations of pool width
    n_busy: jnp.ndarray  # () f32 — sum over iterations of tracking lanes
    # deferred-boundary mode (defer_ggx > 0): lanes waiting for the
    # amortized GGX flush (the full trig-heavy microfacet sampler is the
    # most expensive elementwise block; running it every iteration for
    # the few lanes that hit the boundary is mostly wasted work)
    pend_b: jnp.ndarray  # (N,) bool


def _as_f(x):
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def _pack(s: FastState) -> jnp.ndarray:
    """Per-lane state → one (N, 28) f32 matrix so cascade compaction is
    a single row gather (scalars are threaded separately)."""
    cols = [
        s.o, s.d, s.throughput, s.accum, s.normal,
        s.t[:, None], s.max_t[:, None], s.brick_exit[:, None],
        s.inv_sig_local[:, None],
        _as_f(s.pix)[:, None], _as_f(s.slot)[:, None],
        _as_f(s.samples_done)[:, None], _as_f(s.bounce)[:, None],
        _as_f(s.alive.astype(jnp.int32))[:, None],
        _as_f(s.tracking.astype(jnp.int32))[:, None],
        _as_f(s.rng.state.astype(jnp.int32))[:, None],
        _as_f(s.rng.inc.astype(jnp.int32))[:, None],
        _as_f(s.pend_b.astype(jnp.int32))[:, None],
    ]
    return jnp.concatenate(cols, axis=1)


def _unpack(mat: jnp.ndarray, scalars) -> FastState:
    as_i = lambda x: jax.lax.bitcast_convert_type(x, jnp.int32)
    as_u = lambda x: jax.lax.bitcast_convert_type(x, jnp.uint32)
    n_rays, n_rows, n_busy = scalars
    return FastState(
        o=mat[:, 0:3], d=mat[:, 3:6], throughput=mat[:, 6:9],
        accum=mat[:, 9:12], normal=mat[:, 12:15],
        t=mat[:, 15], max_t=mat[:, 16], brick_exit=mat[:, 17],
        inv_sig_local=mat[:, 18],
        pix=as_i(mat[:, 19]), slot=as_i(mat[:, 20]),
        samples_done=as_i(mat[:, 21]), bounce=as_i(mat[:, 22]),
        alive=as_i(mat[:, 23]) != 0, tracking=as_i(mat[:, 24]) != 0,
        rng=RngState(state=as_u(mat[:, 25]), inc=as_u(mat[:, 26])),
        n_rays=n_rays, n_rows=n_rows, n_busy=n_busy,
        pend_b=as_i(mat[:, 27]) != 0,
    )


def _stochastic_tap(coord, f_bits):
    """Pick the trilerp tap: per axis, the upper neighbor with probability
    frac(coord).  f_bits: 30 random bits (10 per axis) from one draw."""
    c0 = jnp.floor(coord)
    frac = coord - c0
    i0 = c0.astype(jnp.int32)
    ux = ((f_bits >> 0) & 0x3FF).astype(jnp.float32) * (1.0 / 1024.0)
    uy = ((f_bits >> 10) & 0x3FF).astype(jnp.float32) * (1.0 / 1024.0)
    uz = ((f_bits >> 20) & 0x3FF).astype(jnp.float32) * (1.0 / 1024.0)
    up = jnp.stack([ux, uy, uz], axis=-1) < frac
    return i0 + up.astype(jnp.int32)


def _cascade_widths(n_lanes: int, factor: float, min_width: int):
    """Pool widths for the tail-compaction cascade.

    factor may be fractional (e.g. 1.5): finer shrink steps compact
    idle lanes out EARLIER near full width, where most rows live, at
    the cost of more compactions.

    Widths quantize to multiples of 256 (whole 256-lane blocks, which
    keeps the number of distinct pool shapes, and so compiles, small), so
    min_width values below 256 are equivalent to 256.  Fractional
    factors also stall where
    ceil(w/factor/256)*256 == w (e.g. factor 1.25 bottoms at 1024)."""
    import math  # noqa: PLC0415

    widths = [n_lanes]
    while widths[-1] > min_width:
        nxt = max(
            min_width,
            int(math.ceil(widths[-1] / float(factor) / 256.0)) * 256,
        )
        if nxt >= widths[-1]:
            break
        widths.append(nxt)
    return widths


@partial(
    jax.jit,
    static_argnames=(
        "settings", "tile_dim", "full_resolution", "spp", "lanes_per_pixel",
        "two_level", "with_stats", "max_bricks", "brick_size",
        "table_bits", "defer_ggx",
        "brick_major", "cascade_factor",
        "tail_chain", "tail_spec", "tail_width", "spec_width",
        "min_width", "tail_single_level", "tail_bricks",
    ),
)
def render_tile(
    scene: Scene,
    camera: cam.Camera,
    settings: RenderSettings,
    tile_dim: Tuple[int, int],
    tile_offset: jnp.ndarray,
    full_resolution: Tuple[int, int],
    spp: int,
    seed,
    path_id_base,
    lanes_per_pixel: int = 1,
    two_level: bool = False,
    with_stats: bool = False,
    max_bricks: int = _MAX_BRICKS,
    brick_size: Tuple[int, int, int] = None,
    table_bits: int = 32,
    defer_ggx: int = 0,
    brick_major: bool = False,
    cascade_factor: int = _CASCADE_FACTOR,
    tail_chain: int = _TAIL_CHAIN,
    tail_spec: int = _TAIL_SPEC,
    tail_width: int = _TAIL_CHAIN_WIDTH,
    spec_width: int = None,
    min_width: int = None,  # None -> platform default (_default_min_width)
    tail_single_level: bool = False,
    tail_bricks: int = 0,
):
    """defer_ggx=G > 0 batches boundary events: a lane that reaches the
    box surface stalls (pend_b) and the trig-heavy GGX sampler runs once
    every G iterations for all pending lanes under a lax.cond, instead
    of a full-width GGX evaluation every iteration.  Per-lane draw
    order is preserved (the
    event's draws happen later in wall time but at the same position in
    the lane's own stream), so images agree with defer_ggx=0 exactly."""
    tw, th = tile_dim
    n_pix_tile = tw * th
    # Multi-tile lane mode: tile_offset shaped (T, 2) renders ALL T
    # tiles in ONE cascade — lanes cover T*tw*th virtual pixels, each
    # carrying its tile's origin and path-id base (path_id_base is then
    # a (T,) array).  Per-tile path ids and camera jitter match the
    # sequential per-tile calls exactly, so results are bit-identical
    # to looping render_tile over tiles — but tiny-tile configurations
    # (thesis Table 4.2's 64x64 rows; BASELINE config 4's 10x10) stop
    # paying one full cascade drain per tile.
    multi_t = tile_offset.ndim == 2
    n_tiles_batch = tile_offset.shape[0] if multi_t else 1
    n_pix = n_pix_tile * n_tiles_batch
    m = lanes_per_pixel
    while spp % m != 0:
        m -= 1
    spp_per_lane = spp // m
    n_lanes = n_pix * m
    med = scene.medium

    nz, ny, nx = med.density.data.shape
    res_minus_1 = jnp.asarray([nx - 1, ny - 1, nz - 1], jnp.float32)
    extent = med.box_max - med.box_min
    scale = med.scale
    inv_sigmat = 1.0 / (scale * med.max_density)
    albedo_mode = _albedo_mode(scene, allow_split=True)
    flat_tab = albedo_mode != "full"  # 1-D density-only table
    ez_bm, ey_bm, ex_bm = _BM_BRICK
    use_bm = (
        brick_major and flat_tab and albedo_mode != "split"
        and nz % ez_bm == 0 and ny % ey_bm == 0 and nx % ex_bm == 0
    )
    if use_bm:
        fused = brick_major_table(med.density.data)
    else:
        fused = make_fused_grid(scene, albedo_mode)
    if albedo_mode == "split":
        albedo_flat3 = med.albedo.data[..., :3].reshape(-1, 3)

    # -- quantized packed density table (table_bits 8/4) ------------------
    # A random gather's rate depends on whether the table fits in cache,
    # not on the row width.  Packing 32/table_bits voxels per int32
    # (stored as (Vp, 2) uint32 rows, one wide-row gather + a bit
    # extract per tap) shrinks the table 4-8x (the medical f32 table is
    # 67 MB, its 4-bit form 8.4 MB, beside the H100's 50 MB L2).  The
    # stored value is round-to-nearest rho/max_density at 2^bits levels,
    # so each tap's acceptance probability is off by at most
    # 1/(2^(bits+1)-2) of max_density (0.2% at 8 bits — the same order
    # as the reference's 9-bit CUDA texture interpolation weights,
    # CudaVolPath.cpp:171-175).  Majorant tables are built from the
    # DEQUANTIZED grid so the two-level bound stays valid.  Only the
    # 1-channel (const/affine/split albedo) table family packs.
    use_packed = table_bits in (8, 4) and flat_tab
    if table_bits not in (32, 8, 4):
        raise ValueError("table_bits must be 32, 8 or 4")
    if use_packed:
        per = 32 // table_bits  # voxels per uint32
        qmask = jnp.uint32((1 << table_bits) - 1)
        qmax_f = float((1 << table_bits) - 1)
        maxd_f = med.max_density
        q_flat = jnp.round(
            jnp.clip(fused / maxd_f, 0.0, 1.0) * qmax_f
        ).astype(jnp.uint32)
        # Pack along rows of a (R, 128) view: a word holds the per
        # voxels {j : j%128==c, j//128 in [w*per,(w+1)*per)}, i.e.
        # strided-by-128 rather than consecutive.  Every intermediate
        # keeps a 128 trailing dim, so no intermediate has a short
        # trailing dimension (the obvious (Vp, 2, per) reshape ran out
        # of memory at 1024^3 on the backend this was first tuned for).
        pad = (-q_flat.size) % (128 * 2 * per)
        q2 = jnp.pad(q_flat, (0, pad)).reshape(-1, 128)  # (R, 128)
        word2 = jnp.zeros((q2.shape[0] // per, 128), jnp.uint32)
        for k in range(per):
            word2 = word2 | (
                q2[k::per, :] << jnp.uint32(k * table_bits)
            )
        # Layout: (Vp, 2) word-pair rows, one 8-byte gather per tap;
        # above 1 GB of (conservatively 64x padded) pairs the table stays
        # flat 1-D.  Both thresholds predate the H100 and are unmeasured
        # there (ROADMAP S4).
        n_words = word2.size
        packed_pair = n_words * 256 <= (1 << 30)  # padded bytes <= 1 GB
        if packed_pair:
            packed_tab = word2.reshape(-1, 2)  # (Vp, 2) word pairs
        else:
            packed_tab = word2.reshape(-1)  # flat (Vw,)
        dequant = maxd_f / qmax_f

        def dequant_grid(g):
            """round-trip a density grid through the quantizer (the
            values taps will actually see — majorants bound THIS)."""
            return (
                jnp.round(jnp.clip(g / maxd_f, 0.0, 1.0) * qmax_f)
                * dequant
            )

        def fused_take(j):
            """rho at flat index j from the packed table (any shape).
            Index math inverts the row packing above: voxel j sits at
            (r, c) = (j//128, j%128) of the (R, 128) view; its word is
            flat index f = (r//per)*128 + c with shift r%per.  The
            int32-half pick is an elementwise where-select rather than
            a second per-row gather."""
            r = j >> 7
            c = j & 127
            f = (r // per) * 128 + c
            if packed_pair:
                word01 = jnp.take(packed_tab, f >> 1, axis=0)  # (..., 2)
                word = jnp.where(
                    (f & 1) == 0, word01[..., 0], word01[..., 1]
                )
            else:
                word = jnp.take(packed_tab, f, axis=0)
            shift = (r % per).astype(jnp.uint32) * jnp.uint32(table_bits)
            valq = (word >> shift) & qmask
            return valq.astype(jnp.float32) * dequant
    else:
        def dequant_grid(g):
            return g

        def fused_take(j):
            return jnp.take(fused, j, axis=0)

    def tap_flat_idx(ix, iy, iz):
        """Flat table index of a clamped integer tap (row-major or
        brick-major layout).  Brick-major shifts/masks derive from
        _BM_BRICK (powers of two asserted at module load)."""
        if not use_bm:
            return (iz * ny + iy) * nx + ix
        sz, sy, sx = _BM_SHIFT
        mz, my, mx = _BM_MASK
        return (
            (
                ((iz >> sz) * (ny // ey_bm) + (iy >> sy)) * (nx // ex_bm)
                + (ix >> sx)
            )
            * (ez_bm * ey_bm * ex_bm)
            + (((iz & mz) << (sy + sx)) + ((iy & my) << sx) + (ix & mx))
        )

    def row_rho(row):
        """Density channel of a fused-table gather (1-D table rows are
        the densities themselves under constant/affine/split albedo)."""
        return row if flat_tab else row[..., -1]

    def tap_albedo(row, tap_flat, mask):
        """Scatter albedo for lanes in `mask`: decoded from the fused
        row (const/affine/full), or gathered from the scene albedo grid
        at the accepted tap ('split' — the HBM-guard degradation that
        avoids the 16 B/voxel fused duplicate)."""
        if albedo_mode == "split":
            return jnp.take(
                albedo_flat3, jnp.where(mask, tap_flat, 0), axis=0
            )
        return fused_row_decode(scene, row)[1]
    def build_brick_tables(bz_, by_, bx_):
        """Majorant+leap table for one brick granularity.  Stages may
        use DIFFERENT granularities: piecewise-majorant tracking is
        distribution-exact for ANY per-segment majorant >= density, and
        a carried (brick_exit, inv_sig_local) from a coarser table stays
        a valid majorant until the next crossing, so switching tables at
        stage boundaries needs no re-probe."""
        nbz, nby, nbx = -(-nz // bz_), -(-ny // by_), -(-nx // bx_)
        major = brick_majorants(
            dequant_grid(med.density.data), (bz_, by_, bx_)
        )
        # world-space edge of the safe Chebyshev ball around a brick
        edge_world = jnp.asarray([bx_, by_, bz_], jnp.float32) * (
            extent / res_minus_1
        )
        min_edge = jnp.min(edge_world)
        cheb = brick_chebyshev_distance(major)
        # safe leap beyond the brick exit: (D-1) empty rings, shaved by
        # an epsilon so float rounding cannot poke past the guarantee
        leap = jnp.maximum(cheb - 1.0, 0.0) * min_edge * (1.0 - 1e-6)
        tab = jnp.stack(
            [major.reshape(-1), leap.reshape(-1)], axis=-1
        )  # (B, 2): fast-path gather rows
        return dict(
            tab=tab,
            size=jnp.asarray([bx_, by_, bz_], jnp.float32),
            hi=jnp.asarray([nbx - 1, nby - 1, nbz - 1], jnp.int32),
            nby=nby, nbx=nbx,
        )

    if two_level:
        # brick_size overrides pick_brick (sweep lever: bricks finer
        # than pick_brick's candidate list, e.g. 2^3 for the smoke
        # class where scale 800 makes majorant tightness dominate)
        coarse_bt = build_brick_tables(
            *(brick_size or pick_brick((nz, ny, nx), max_bricks))
        )
        # tail pools are latency-bound (per-iteration cost is fixed, so
        # iterations are what matter): tighter majorants cut null
        # collisions on the few deep surviving paths, even though the
        # finer probe table would lose at full width (more crossings)
        fine_bt = (
            build_brick_tables(tail_bricks, tail_bricks, tail_bricks)
            if tail_bricks > 0
            else None
        )

    lane = jnp.arange(n_lanes, dtype=jnp.uint32)
    pix0 = (lane % jnp.uint32(n_pix)).astype(jnp.int32)
    slot0 = (lane // jnp.uint32(n_pix)).astype(jnp.int32)

    if multi_t:
        bases_u32 = jnp.asarray(path_id_base, jnp.uint32)  # (T,)

        def path_id_of(pix, slot, samples_done):
            s = slot.astype(jnp.uint32) + jnp.uint32(
                m
            ) * samples_done.astype(jnp.uint32)
            tix = pix // n_pix_tile
            local = (pix % n_pix_tile).astype(jnp.uint32)
            return (
                s * jnp.uint32(n_pix_tile) + local
                + jnp.take(bases_u32, tix, axis=0)
            )

        def pixel_xy_of(pix):
            local = pix % n_pix_tile
            off = jnp.take(tile_offset, pix // n_pix_tile, axis=0)
            px = (local % tw).astype(jnp.float32) + off[..., 0]
            py = jnp.floor(local.astype(jnp.float32) / tw) + off[..., 1]
            return jnp.stack([px, py], axis=-1)
    else:
        def path_id_of(pix, slot, samples_done):
            s = slot.astype(jnp.uint32) + jnp.uint32(
                m
            ) * samples_done.astype(jnp.uint32)
            return (
                s * jnp.uint32(n_pix) + pix.astype(jnp.uint32)
                + jnp.asarray(path_id_base, jnp.uint32)
            )

        def pixel_xy_of(pix):
            px = (pix % tw).astype(jnp.float32) + tile_offset[0]
            py = jnp.floor(pix.astype(jnp.float32) / tw) + tile_offset[1]
            return jnp.stack([px, py], axis=-1)

    zero3 = jnp.zeros((n_lanes, 3), jnp.float32)
    zero1 = jnp.zeros((n_lanes,), jnp.float32)
    state0 = FastState(
        o=zero3, d=zero3.at[:, 2].set(1.0), throughput=jnp.ones_like(zero3),
        accum=zero3, normal=zero3,
        t=zero1, max_t=zero1,
        brick_exit=zero1 - 1.0, inv_sig_local=zero1,
        pix=pix0, slot=slot0,
        samples_done=jnp.zeros((n_lanes,), jnp.int32),
        bounce=jnp.zeros((n_lanes,), jnp.int32),
        alive=jnp.zeros((n_lanes,), bool),
        tracking=jnp.zeros((n_lanes,), bool),
        rng=make_rng(seed, jnp.zeros((n_lanes,), jnp.uint32)),
        n_rays=jnp.zeros((), jnp.float32),
        n_rows=jnp.zeros((), jnp.float32),
        n_busy=jnp.zeros((), jnp.float32),
        pend_b=jnp.zeros((n_lanes,), bool),
    )

    def flush_boundary(s: FastState) -> FastState:
        """Run the boundary event for every pending lane (one batched
        GGX evaluation), mirroring the inline event semantics exactly:
        event → bounce+1 → path cap → Russian roulette."""
        pend = s.pend_b
        o_bound = s.o + s.d * s.max_t[..., None]
        o_b, d_b, t_b, rng = integrator.boundary_event(
            scene, settings, s.normal, o_bound, s.d, s.throughput,
            s.rng, pend,
        )
        o = jnp.where(pend[..., None], o_b, s.o)
        d = jnp.where(pend[..., None], d_b, s.d)
        tput = jnp.where(pend[..., None], t_b, s.throughput)
        bounce = jnp.where(pend, s.bounce + 1, s.bounce)
        alive, samples_done = s.alive, s.samples_done
        capped = jnp.logical_and(pend, bounce >= settings.max_path_length)
        alive = jnp.logical_and(alive, jnp.logical_not(capped))
        samples_done = jnp.where(capped, samples_done + 1, samples_done)
        if settings.russian_roulette:
            rr_mask = jnp.logical_and(pend, jnp.logical_not(capped))
            tput, alive, killed, rng = integrator.russian_roulette(
                tput, alive, rng, rr_mask
            )
            samples_done = jnp.where(
                killed, samples_done + 1, samples_done
            )
        return s._replace(
            o=o, d=d, throughput=tput, bounce=bounce, alive=alive,
            samples_done=samples_done, rng=rng,
            pend_b=jnp.zeros_like(pend),
        )

    def body(s, spec_k=1, single_level=False, bt=None):
        if bt is None and two_level:
            bt = coarse_bt
        if two_level and not single_level:
            brick_tab, brick_size, brick_hi = bt["tab"], bt["size"], bt["hi"]
            nby, nbx = bt["nby"], bt["nbx"]
        width = s.alive.shape[0]
        if defer_ggx > 0:
            # amortized boundary flush every defer_ggx iterations
            # (n_rows/width counts this stage's body calls exactly)
            it = jnp.round(s.n_rows / float(width))
            s = jax.lax.cond(
                it % defer_ggx == 0, flush_boundary, lambda x: x, s
            )
        # --- regenerate: next sample of the lane's pixel -----------------
        needs = jnp.logical_and(
            jnp.logical_not(s.alive), s.samples_done < spp_per_lane
        )
        fresh = make_rng(seed, path_id_of(s.pix, s.slot, s.samples_done))
        rng = RngState(
            state=jnp.where(needs, fresh.state, s.rng.state),
            inc=jnp.where(needs, fresh.inc, s.rng.inc),
        )
        pixel_xy = pixel_xy_of(s.pix)
        o_new, d_new, rng = cam.generate_rays(
            camera, pixel_xy, full_resolution, rng, active=needs
        )
        mm = needs[..., None]
        o = jnp.where(mm, o_new, s.o)
        d = jnp.where(mm, d_new, s.d)
        tput = jnp.where(mm, 1.0, s.throughput)
        alive = jnp.logical_or(s.alive, needs)
        tracking = jnp.where(needs, False, s.tracking)
        bounce = jnp.where(needs, 0, s.bounce)

        # --- segment start: AABB + classification ------------------------
        need_isect = jnp.logical_and(alive, jnp.logical_not(tracking))
        if defer_ggx > 0:
            # stalled lanes wait for the boundary flush
            need_isect = jnp.logical_and(
                need_isect, jnp.logical_not(s.pend_b)
            )
        n_rays = s.n_rays + jnp.sum(need_isect.astype(jnp.float32))
        isect = aabb.aabb_intersect(med.box_min, med.box_max, o, d)
        miss = jnp.logical_and(need_isect, jnp.logical_not(isect.hit))
        accum = jnp.where(
            miss[..., None], s.accum + tput * scene.le, s.accum
        )
        samples_done = jnp.where(miss, s.samples_done + 1, s.samples_done)
        alive = jnp.logical_and(alive, jnp.logical_not(miss))

        enters = jnp.logical_and(
            need_isect, jnp.logical_and(isect.hit, isect.inside_volume)
        )
        boundary_now = jnp.logical_and(
            need_isect,
            jnp.logical_and(isect.hit, jnp.logical_not(isect.inside_volume)),
        )
        tracking = jnp.logical_or(tracking, enters)
        t = jnp.where(enters, 0.0, s.t)
        max_t = jnp.where(enters, isect.dist, s.max_t)
        normal = jnp.where(need_isect[..., None], isect.normal, s.normal)
        brick_exit = jnp.where(enters, -1.0, s.brick_exit)
        inv_sig_local = s.inv_sig_local

        # --- tracking ------------------------------------------------------
        if two_level and not single_level:
            # Two-level (sparse-leap) delta tracking, split-table edition:
            # brick probes hit the small fast-path (B, 2) majorant+leap
            # table, density taps hit the (V, 4) fused table, and a brick
            # entry probes AND takes its first Woodcock step in the same
            # iteration.  Empty bricks leap (D-1) brick-edges at once via
            # the distance-transform channel.  Piecewise-majorant
            # tracking stays distribution-exact; per-lane draw sequences
            # are identical to the fused-probe round-1 implementation.
            epsw = jnp.max(extent) * 1e-6
            need_brick = jnp.logical_and(tracking, t >= brick_exit)
            p_now = o + (t + epsw)[..., None] * d
            coordn = (
                jnp.clip((p_now - med.box_min) / extent, 0.0, 1.0)
                * res_minus_1
            )
            bi = jnp.clip(
                jnp.floor(coordn / brick_size).astype(jnp.int32),
                0,
                brick_hi,
            )
            bflat = (bi[..., 2] * nby + bi[..., 1]) * nbx + bi[..., 0]
            row_b = jnp.take(
                brick_tab, jnp.where(need_brick, bflat, 0), axis=0
            )  # (N, 2) — small-table fast-path gather
            rho_b = row_b[..., 0]
            leap_b = row_b[..., 1]

            # fresh DDA brick exit for probing lanes
            up = (d > 0.0).astype(jnp.float32)
            bound_coord = (bi.astype(jnp.float32) + up) * brick_size
            bound_world = med.box_min + extent * bound_coord / res_minus_1
            okd = jnp.abs(d) > 1e-12
            t_axes = jnp.where(
                okd, (bound_world - o) / jnp.where(okd, d, 1.0), jnp.inf
            )
            exit_new = jnp.maximum(jnp.min(t_axes, axis=-1), t + epsw)
            brick_exit = jnp.where(need_brick, exit_new, brick_exit)
            inv_new = jnp.where(
                rho_b > 0.0,
                1.0 / (scale * jnp.maximum(rho_b, 1e-30)),
                jnp.inf,
            )
            inv_sig_local = jnp.where(need_brick, inv_new, inv_sig_local)

            # empty bricks: leap the whole guaranteed-empty Chebyshev ball
            probe_empty = jnp.logical_and(need_brick, rho_b <= 0.0)
            t_leap = jnp.maximum(exit_new, t + leap_b)
            overran_empty = jnp.logical_and(probe_empty, t_leap >= max_t)

            # every lane with a live finite majorant steps this iteration
            # (fresh probes included — probe+step fusion)
            stepping = jnp.logical_and(
                tracking, jnp.logical_not(probe_empty)
            )
            eff_exit = jnp.minimum(brick_exit, max_t)

            def clipped_tap_flat(t_at, bits):
                p_at = o + t_at[..., None] * d
                coord = (
                    jnp.clip((p_at - med.box_min) / extent, 0.0, 1.0)
                    * res_minus_1
                )
                tap = _stochastic_tap(coord, bits)
                ix = jnp.clip(tap[..., 0], 0, nx - 1)
                iy = jnp.clip(tap[..., 1], 0, ny - 1)
                iz = jnp.clip(tap[..., 2], 0, nz - 1)
                return tap_flat_idx(ix, iy, iz)

            if spec_k == 1:
                u1, rng = next_float(rng, stepping)
                step = jnp.where(
                    stepping,
                    -jnp.log(jnp.maximum(u1, EPSILON)) * inv_sig_local,
                    0.0,
                )
                t_cand = t + step
                crossed_step = jnp.logical_and(
                    stepping, t_cand >= eff_exit
                )
                inside = jnp.logical_and(
                    stepping, jnp.logical_not(crossed_step)
                )
                tap_bits, rng = next_uint32(rng, inside)
                tap_flat = clipped_tap_flat(t_cand, tap_bits)
                row = fused_take(
                    jnp.where(inside, tap_flat, 0)
                )  # (N, 4) / (N,) packed
                rho_hat = row_rho(row)
                u2, rng = next_float(rng, inside)
                accepted = jnp.logical_and(
                    inside,
                    jnp.logical_not(scale * rho_hat * inv_sig_local < u2),
                )
                alb_hat = tap_albedo(row, tap_flat, accepted)
                advance = inside
                t_adv = t_cand
            else:
                # Speculative multi-step tracking (tail pools): draw
                # spec_k majorant steps at once, fetch all taps in ONE
                # gather (the serial probe→tap→probe latency chain is
                # what bounds narrow tail iterations), then keep the
                # prefix up to the first acceptance or brick crossing.
                # The thinned steps are iid, so taking that prefix is
                # the same stochastic process — distribution-exact.
                t_run = t
                cands = []
                for _ in range(spec_k):
                    u1, rng = next_float(rng, stepping)
                    t_run = t_run + jnp.where(
                        stepping,
                        -jnp.log(jnp.maximum(u1, EPSILON)) * inv_sig_local,
                        0.0,
                    )
                    cands.append(t_run)
                t_cands = jnp.stack(cands, axis=-1)  # (N, K)
                validj = jnp.logical_and(
                    stepping[..., None], t_cands < eff_exit[..., None]
                )
                flats = []
                for j in range(spec_k):
                    tap_bits, rng = next_uint32(rng, validj[..., j])
                    flats.append(
                        clipped_tap_flat(t_cands[..., j], tap_bits)
                    )
                idxk = jnp.stack(flats, axis=-1)  # (N, K)
                rows = fused_take(
                    jnp.where(validj, idxk, 0)
                )  # (N, K, 4) / (N, K) packed
                u2s = []
                for j in range(spec_k):
                    u2, rng = next_float(rng, validj[..., j])
                    u2s.append(u2)
                u2k = jnp.stack(u2s, axis=-1)
                acceptj = jnp.logical_and(
                    validj,
                    jnp.logical_not(
                        scale * row_rho(rows) * inv_sig_local[..., None]
                        < u2k
                    ),
                )
                stopj = jnp.logical_or(
                    acceptj, jnp.logical_not(validj)
                )
                j0 = jnp.argmax(stopj, axis=-1)
                any_stop = jnp.any(stopj, axis=-1)
                if flat_tab:
                    row0 = jnp.take_along_axis(rows, j0[..., None], axis=1)[
                        :, 0
                    ]
                else:
                    row0 = jnp.take_along_axis(
                        rows, j0[..., None, None], axis=1
                    )[:, 0, :]
                t0v = jnp.take_along_axis(t_cands, j0[..., None], axis=1)[
                    :, 0
                ]
                acc0 = jnp.take_along_axis(acceptj, j0[..., None], axis=1)[
                    :, 0
                ]
                accepted = jnp.logical_and(
                    stepping, jnp.logical_and(any_stop, acc0)
                )
                crossed_step = jnp.logical_and(
                    stepping,
                    jnp.logical_and(any_stop, jnp.logical_not(acc0)),
                )
                tap0 = jnp.take_along_axis(idxk, j0[..., None], axis=1)[
                    :, 0
                ]
                alb_hat = tap_albedo(row0, tap0, accepted)
                # no stop within K valid steps: advance and keep tracking
                advance = jnp.logical_and(
                    stepping,
                    jnp.logical_or(accepted, jnp.logical_not(any_stop)),
                )
                t_adv = jnp.where(any_stop, t0v, t_cands[..., -1])

            overran_step = jnp.logical_and(
                crossed_step, max_t <= brick_exit
            )
            transit = jnp.logical_and(
                crossed_step, jnp.logical_not(overran_step)
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
                        jnp.where(advance, t_adv, t),
                    ),
                ),
            )
            # leaping lanes re-probe wherever they landed
            brick_exit = jnp.where(probe_empty, -1.0, brick_exit)
            overran = jnp.logical_or(overran_step, overran_empty)
            terminated = jnp.logical_or(overran, accepted)
            scattered = accepted
            tracking = jnp.logical_and(
                tracking, jnp.logical_not(terminated)
            )
        elif spec_k == 1:
            step_mask = tracking
            u1, rng = next_float(rng, step_mask)
            step = -jnp.log(jnp.maximum(u1, EPSILON)) * inv_sigmat
            t_new = jnp.where(step_mask, t + step, t)
            p = o + t_new[..., None] * d
            coord = (
                jnp.clip((p - med.box_min) / extent, 0.0, 1.0) * res_minus_1
            )
            tap_bits, rng = next_uint32(rng, step_mask)
            tap = _stochastic_tap(coord, tap_bits)
            ix = jnp.clip(tap[..., 0], 0, nx - 1)
            iy = jnp.clip(tap[..., 1], 0, ny - 1)
            iz = jnp.clip(tap[..., 2], 0, nz - 1)
            tap_flat = tap_flat_idx(ix, iy, iz)
            row = fused_take(tap_flat)  # (N,4) / (N,) packed
            rho_hat = row_rho(row)
            u2, rng = next_float(rng, step_mask)
            overran = t_new > max_t
            accepted = jnp.logical_not(scale * rho_hat * inv_sigmat < u2)
            terminated = jnp.logical_and(
                step_mask, jnp.logical_or(overran, accepted)
            )
            scattered = jnp.logical_and(
                terminated, jnp.logical_not(overran)
            )
            alb_hat = tap_albedo(row, tap_flat, scattered)
            t = t_new
            tracking = jnp.logical_and(
                tracking, jnp.logical_not(terminated)
            )
        else:
            # Speculative single-level tracking: draw spec_k global-
            # majorant steps at once, fetch all taps in ONE gather, keep
            # the prefix up to the first acceptance or boundary overrun.
            # Unlike the two-level spec path there are no brick
            # crossings, so every candidate before the overrun is a
            # valid Woodcock step — the narrow-tail case where the
            # per-gather latency floor dominates gets spec_k steps per
            # body at one gather's cost.  Thinned steps are iid: taking
            # the stopped prefix is the same stochastic process.
            step_mask = tracking
            t_run = t
            cands = []
            for _ in range(spec_k):
                u1, rng = next_float(rng, step_mask)
                t_run = t_run + jnp.where(
                    step_mask,
                    -jnp.log(jnp.maximum(u1, EPSILON)) * inv_sigmat,
                    0.0,
                )
                cands.append(t_run)
            t_cands = jnp.stack(cands, axis=-1)  # (N, K)
            in_vol = jnp.logical_and(
                step_mask[..., None], t_cands <= max_t[..., None]
            )
            flats = []
            for j in range(spec_k):
                tap_bits, rng = next_uint32(rng, in_vol[..., j])
                p_j = o + t_cands[..., j, None] * d
                coord_j = (
                    jnp.clip((p_j - med.box_min) / extent, 0.0, 1.0)
                    * res_minus_1
                )
                tap_j = _stochastic_tap(coord_j, tap_bits)
                flats.append(
                    tap_flat_idx(
                        jnp.clip(tap_j[..., 0], 0, nx - 1),
                        jnp.clip(tap_j[..., 1], 0, ny - 1),
                        jnp.clip(tap_j[..., 2], 0, nz - 1),
                    )
                )
            idxk = jnp.stack(flats, axis=-1)  # (N, K)
            rows = fused_take(jnp.where(in_vol, idxk, 0))
            u2s = []
            for j in range(spec_k):
                u2, rng = next_float(rng, in_vol[..., j])
                u2s.append(u2)
            u2k = jnp.stack(u2s, axis=-1)
            acceptj = jnp.logical_and(
                in_vol,
                jnp.logical_not(scale * row_rho(rows) * inv_sigmat < u2k),
            )
            # a candidate stops the prefix if it accepts or leaves the box
            stopj = jnp.logical_or(
                acceptj, jnp.logical_not(in_vol)
            )
            j0 = jnp.argmax(stopj, axis=-1)
            any_stop = jnp.any(stopj, axis=-1)
            if flat_tab:
                row0 = jnp.take_along_axis(rows, j0[..., None], axis=1)[
                    :, 0
                ]
            else:
                row0 = jnp.take_along_axis(
                    rows, j0[..., None, None], axis=1
                )[:, 0, :]
            t0v = jnp.take_along_axis(t_cands, j0[..., None], axis=1)[:, 0]
            acc0 = jnp.take_along_axis(acceptj, j0[..., None], axis=1)[
                :, 0
            ]
            tap0 = jnp.take_along_axis(idxk, j0[..., None], axis=1)[:, 0]
            accepted = jnp.logical_and(
                step_mask, jnp.logical_and(any_stop, acc0)
            )
            overran = jnp.logical_and(
                step_mask,
                jnp.logical_and(any_stop, jnp.logical_not(acc0)),
            )
            terminated = jnp.logical_and(
                step_mask, jnp.logical_or(accepted, overran)
            )
            scattered = accepted
            alb_hat = tap_albedo(row0, tap0, scattered)
            t = jnp.where(
                step_mask,
                jnp.where(any_stop, t0v, t_cands[..., -1]),
                t,
            )
            tracking = jnp.logical_and(
                tracking, jnp.logical_not(terminated)
            )

        # --- boundary event ----------------------------------------------
        boundary = jnp.logical_or(
            boundary_now, jnp.logical_and(terminated, overran)
        )
        pend_b = s.pend_b
        if defer_ggx > 0:
            # record the boundary distance and stall; the flush applies
            # the GGX event in a batched pass
            max_t = jnp.where(boundary_now, isect.dist, max_t)
            pend_b = jnp.logical_or(pend_b, boundary)
            boundary = jnp.zeros_like(boundary)
        o_bound = jnp.where(
            boundary_now[..., None],
            o + d * isect.dist[..., None],
            o + d * max_t[..., None],
        )
        if defer_ggx == 0:
            o_b, d_b, t_b, rng = integrator.boundary_event(
                scene, settings, normal, o_bound, d, tput, rng, boundary
            )

        # --- scatter event: reuse the accepted tap's albedo --------------
        o_s = o + d * t[..., None] - d * EPSILON
        d_s, rng = phase.sample_phase(d, med.g, rng, active=scattered)

        if defer_ggx == 0:
            o = jnp.where(
                scattered[..., None], o_s,
                jnp.where(boundary[..., None], o_b, o),
            )
            d = jnp.where(
                scattered[..., None], d_s,
                jnp.where(boundary[..., None], d_b, d),
            )
            tput = jnp.where(
                scattered[..., None], tput * alb_hat,
                jnp.where(boundary[..., None], t_b, tput),
            )
        else:
            o = jnp.where(scattered[..., None], o_s, o)
            d = jnp.where(scattered[..., None], d_s, d)
            tput = jnp.where(scattered[..., None], tput * alb_hat, tput)

        # --- path-length cap + Russian roulette after events --------------
        had_event = jnp.logical_and(
            alive, jnp.logical_or(scattered, boundary)
        )
        bounce = jnp.where(had_event, bounce + 1, bounce)
        # the reference bounds every path at max_path_length events
        # (Config.h PathTracingConfig; the for-loop bound in every kernel)
        capped = jnp.logical_and(
            alive, bounce >= settings.max_path_length
        )
        alive = jnp.logical_and(alive, jnp.logical_not(capped))
        tracking = jnp.logical_and(tracking, jnp.logical_not(capped))
        samples_done = jnp.where(capped, samples_done + 1, samples_done)
        if settings.russian_roulette:
            rr_mask = jnp.logical_and(
                had_event, jnp.logical_not(capped)
            )
            tput, alive, killed, rng = integrator.russian_roulette(
                tput, alive, rng, rr_mask
            )
            samples_done = jnp.where(
                killed, samples_done + 1, samples_done
            )

        return FastState(
            o=o, d=d, throughput=tput, accum=accum, normal=normal,
            t=t, max_t=max_t,
            brick_exit=brick_exit, inv_sig_local=inv_sig_local,
            pix=s.pix, slot=s.slot,
            samples_done=samples_done, bounce=bounce,
            alive=alive, tracking=tracking,
            rng=rng, n_rays=n_rays,
            n_rows=s.n_rows + float(width),
            n_busy=s.n_busy + jnp.sum(tracking.astype(jnp.float32)),
            pend_b=pend_b,
        )

    def pending_count(s):
        pending = jnp.logical_or(s.alive, s.samples_done < spp_per_lane)
        return jnp.sum(pending.astype(jnp.int32))

    # --- cascade: shrink the pool as the tail empties ---------------------
    if min_width is None:
        min_width = _default_min_width()
    widths = _cascade_widths(n_lanes, cascade_factor, min_width)
    img = jnp.zeros((n_pix, 3), jnp.float32)
    state = state0
    stage_rows = []  # per-stage lane-rows (with_stats diagnostics)

    def flush_compact(state, img, next_width):
        """Flush finished lanes' accumulators and argsort-compact the
        pending lanes into a next_width pool."""
        pending = jnp.logical_or(
            state.alive, state.samples_done < spp_per_lane
        )
        flush_idx = jnp.where(pending, n_pix, state.pix)  # n_pix drops
        img = img.at[flush_idx].add(state.accum, mode="drop")
        # flushed lanes may survive the cut when pending < next width:
        # zero their accumulators so nothing flushes twice
        state = state._replace(
            accum=jnp.where(pending[..., None], state.accum, 0.0)
        )
        order = jnp.argsort(
            jnp.logical_not(pending).astype(jnp.int32)
        )[:next_width]
        packed = jnp.take(_pack(state), order, axis=0)
        state = _unpack(
            packed, (state.n_rays, state.n_rows, state.n_busy)
        )
        return state, img

    for stage, width in enumerate(widths):
        last = stage == len(widths) - 1
        thresh = 0 if last else widths[stage + 1]
        # narrow tail pools amortize per-iteration loop overhead by
        # chaining several complete body evaluations per while-iteration
        # (each is a full, correct iteration; masked draws keep per-path
        # streams identical, extra evaluations past the exit condition
        # are no-ops)
        tail = len(widths) > 1 and width <= tail_width
        k_chain = tail_chain if tail else 1
        # narrow pools may switch to single-level tracking (global
        # majorant): no brick crossings means every speculative step
        # stays valid, so spec-K amortizes the fixed per-gather latency
        # that floors narrow-pool iterations.  Distribution-exact: the
        # majorant choice is free in Woodcock tracking, and restarting a
        # mid-flight lane under the global majorant is memoryless.
        # spec_width is separate from tail_width because an (N, K)
        # gather only rides the latency floor when N*K stays small —
        # spec-8 at 16384 lanes is a 131k-row gather, far off the floor.
        spec_w = tail_width if spec_width is None else spec_width
        narrow = len(widths) > 1 and width <= spec_w
        sl = narrow and tail_single_level and two_level
        k_spec = tail_spec if narrow else 1

        # narrow pools may probe a FINER brick table (tail_bricks>0):
        # tighter majorants mean fewer null-collision iterations, which
        # is all that matters at the latency floor
        bt_stage = (
            fine_bt
            if (two_level and tail and fine_bt is not None)
            else (coarse_bt if two_level else None)
        )

        chained = chain_body(
            partial(body, spec_k=k_spec, single_level=sl, bt=bt_stage),
            k_chain,
        )

        def cond(s, _thresh=thresh):
            return pending_count(s) > _thresh

        rows_before = state.n_rows
        state = jax.lax.while_loop(cond, chained, state)
        stage_rows.append(state.n_rows - rows_before)
        if last:
            # all lanes finished: flush every accumulator
            img = img.at[state.pix].add(state.accum, mode="drop")
        else:
            state, img = flush_compact(state, img, widths[stage + 1])

    img = (
        img.reshape(n_tiles_batch, th, tw, 3)
        if multi_t else img.reshape(th, tw, 3)
    )
    if with_stats:
        return (
            img, state.n_rays, state.n_rows, state.n_busy,
            jnp.stack(stage_rows),
        )
    return img, state.n_rays

