"""Inverse rendering: recover density/albedo grids from target renders.

The differentiable capability BASELINE.json adds over the reference
(config 5: "recover a density grid from target renders, sharded over
hosts").  Builds on the path-replay custom_vjp (models/differentiable.py)
and the sharded gradient step (parallel/shard.py), and adds the real
checkpoint/resume the reference lacks (SURVEY.md §5: orbax-style
checkpointing of the optimized grid + step + PRNG state).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..scene.types import RenderSettings
from .differentiable import CameraSpec, SceneSpec, render_diff


@dataclasses.dataclass
class InverseConfig:
    resolution: Tuple[int, int] = (32, 32)
    spp: int = 64
    learning_rate: float = 0.5
    n_steps: int = 200
    seed: int = 7
    optimize_albedo: bool = False
    #: sparse-leap stochastic-tap estimator for fwd+bwd — required for
    #: large grids (global-majorant replay is intractable at 256^3+)
    two_level: bool = False
    clip_density: Tuple[float, float] = (0.0, 1.0)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    #: total-variation smoothness prior weight on the density grid
    #: (0 = off).  Stabilizes big-grid recoveries where the per-voxel
    #: score gradient is sparse/noisy.
    tv_weight: float = 0.0
    #: views per step when running multi-view: cycles through the view
    #: set round-robin (stochastic view minibatching) so every step
    #: renders only `views_per_step` images
    views_per_step: int = 1
    #: split each view's fwd+bwd into this many independent sample
    #: chunks of spp/spp_chunks each, run as SEPARATE device programs
    #: whose grads are averaged.  Chunking bounds each program's
    #: duration and its live memory (the cotangent buffers scale with
    #: the samples in flight).  Per-view splitting is
    #: exact (the multi-view loss is a mean of per-view MSEs); spp
    #: splitting swaps MSE-of-mean for mean-of-chunk-MSE, the same
    #: surrogate the per-step stochastic loss already minimizes.
    spp_chunks: int = 1


def make_loss_fn(
    scene_spec: SceneSpec,
    camera_spec: CameraSpec,
    settings: RenderSettings,
    config: InverseConfig,
):
    spp = config.spp

    def loss_fn(density, albedo, target, seed):
        img = render_diff(
            density, albedo, seed, scene_spec, camera_spec, settings,
            config.resolution, spp, config.two_level,
        ) / float(spp)
        return jnp.mean((img - target) ** 2)

    return loss_fn


def _tv_loss(density):
    """Anisotropic total-variation prior: mean squared forward
    difference along each axis."""
    t = 0.0
    for ax in range(3):
        d = jnp.diff(density, axis=ax)
        t = t + jnp.mean(d * d)
    return t / 3.0


def make_multiview_loss_fn(
    scene_spec: SceneSpec,
    camera_specs: Sequence[CameraSpec],
    settings: RenderSettings,
    config: InverseConfig,
):
    """Mean MSE over several camera poses (CameraSpec.look_at).

    Multi-view constraints are what make 3-D density recovery
    well-posed: a single view cannot disambiguate depth along rays.
    `targets` stacks per-view images (V, H, W, 3); per-view sample
    streams are decorrelated by hashing the view index into the seed.
    """
    spp = config.spp

    def loss_fn(density, albedo, targets, seed):
        total = 0.0
        for v, cam_spec in enumerate(camera_specs):
            view_seed = (
                seed + jnp.uint32(v * 2246822519 % (1 << 31))
            ).astype(jnp.uint32)
            img = render_diff(
                density, albedo, view_seed, scene_spec, cam_spec,
                settings, config.resolution, spp, config.two_level,
            ) / float(spp)
            total = total + jnp.mean((img - targets[v]) ** 2)
        total = total / float(len(camera_specs))
        if config.tv_weight > 0.0:
            total = total + config.tv_weight * _tv_loss(density)
        return total

    return loss_fn


def make_view_loss_fn(
    scene_spec: SceneSpec,
    camera_proto: CameraSpec,
    settings: RenderSettings,
    config: InverseConfig,
):
    """Single-compilation multi-view loss: the camera is a TRACED
    Camera pytree (render_diff's `camera` override), so one jitted
    value_and_grad serves every pose — view minibatching with no
    per-view recompiles."""
    spp = config.spp

    def loss_fn(density, albedo, target, seed, camera):
        img = render_diff(
            density, albedo, seed, scene_spec, camera_proto, settings,
            config.resolution, spp, config.two_level, camera,
        ) / float(spp)
        loss = jnp.mean((img - target) ** 2)
        if config.tv_weight > 0.0:
            loss = loss + config.tv_weight * _tv_loss(density)
        return loss

    return loss_fn


def orbit_camera_specs(
    n_views: int,
    radius: float = 100.0,
    res: Tuple[int, int] = (32, 32),
    fov_x_deg: float = 0.7,
    center: Tuple[float, float, float] = (0.0, 0.0, 0.0),
) -> Tuple[CameraSpec, ...]:
    """Evenly spaced look-at poses on a horizontal orbit around the
    volume (the standard multi-view inverse-rendering capture rig)."""
    specs = []
    for v in range(n_views):
        theta = 2.0 * np.pi * v / n_views
        eye = (
            center[0] + radius * float(np.sin(theta)),
            center[1],
            center[2] + radius * float(np.cos(theta)),
        )
        specs.append(
            CameraSpec(
                res_x=res[0], res_y=res[1], fov_x_deg=fov_x_deg,
                position=eye, look_at=center,
            )
        )
    return tuple(specs)


def _save_checkpoint(path, step, density, albedo, opt_state, seed=None):
    """Write one self-contained .npz checkpoint: grid(s) + step + seed +
    the FULL optimizer-state pytree (flattened leaves).

    SURVEY.md §5 requires grid + step/PRNG state; all sample streams are
    derived statelessly from (config.seed, step), so persisting those two
    scalars IS persisting the PRNG state — a resumed run replays the
    exact seed sequence of an unbroken run (tests/test_inverse.py).
    Adam moments are saved leaf-by-leaf and re-attached on load to the
    treedef of a fresh `optimizer.init(params)`, so resume continues the
    same trajectory instead of silently resetting the moments (the
    round-2 bug: opt_state was accepted and dropped)."""
    os.makedirs(path, exist_ok=True)
    payload = {
        "density": np.asarray(density),
        "albedo": np.asarray(albedo),
        "step": np.int64(step),
    }
    if seed is not None:
        payload["seed"] = np.int64(seed)
    if opt_state is not None:
        leaves = jax.tree_util.tree_leaves(opt_state)
        payload["n_opt_leaves"] = np.int64(len(leaves))
        for i, leaf in enumerate(leaves):
            payload[f"opt_{i}"] = np.asarray(leaf)
    # np.savez appends .npz when missing, so the tmp name must carry it
    tmp = os.path.join(path, f".tmp_step_{step}.npz")
    np.savez(tmp, **payload)
    os.replace(tmp, os.path.join(path, f"step_{step}.npz"))


def load_checkpoint(path: str, step: int, opt_state_like=None):
    """Load a checkpoint.  Returns (density, albedo, step) — plus the
    restored optimizer state when `opt_state_like` (a template pytree,
    e.g. `optimizer.init(params)`) is given and the checkpoint carries
    the moments."""
    data = np.load(os.path.join(path, f"step_{step}.npz"))
    out = (data["density"], data["albedo"], int(data["step"]))
    if opt_state_like is None:
        return out
    if "n_opt_leaves" not in data.files:
        return out + (None,)
    n = int(data["n_opt_leaves"])
    template_leaves, treedef = jax.tree_util.tree_flatten(opt_state_like)
    if len(template_leaves) != n:
        raise ValueError(
            f"checkpoint has {n} optimizer leaves, template has "
            f"{len(template_leaves)} — optimizer mismatch"
        )
    leaves = [
        jnp.asarray(data[f"opt_{i}"], template_leaves[i].dtype)
        for i in range(n)
    ]
    return out + (jax.tree_util.tree_unflatten(treedef, leaves),)


def find_latest_checkpoint(path: str):
    """Largest checkpointed step in `path`, or None."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_") and name.endswith(".npz"):
            try:
                steps.append(int(name[len("step_"):-len(".npz")]))
            except ValueError:
                continue
    return max(steps) if steps else None


def run_inverse(
    target: jnp.ndarray,  # (H, W, 3) target image (mean radiance)
    density0: jnp.ndarray,
    albedo0: jnp.ndarray,
    scene_spec: SceneSpec,
    camera_spec: CameraSpec,
    settings: RenderSettings,
    config: InverseConfig,
    progress: Optional[Callable[[int, float], None]] = None,
):
    """Adam-optimize the density (and optionally albedo) grid to match
    the target.  Per-step fresh sample streams (seed + step) keep the
    gradient estimator unbiased across steps.  Returns (density, albedo,
    losses).

    Multi-view: pass a sequence of CameraSpec (e.g. orbit_camera_specs)
    and a stacked (V, H, W, 3) target; the loss averages over views."""
    if isinstance(camera_spec, (list, tuple)):
        loss_fn = make_multiview_loss_fn(
            scene_spec, camera_spec, settings, config
        )
    else:
        loss_fn = make_loss_fn(scene_spec, camera_spec, settings, config)
    optimizer = optax.adam(config.learning_rate)

    if config.optimize_albedo:
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))
    else:
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=(0,)))

    params = (
        (density0, albedo0) if config.optimize_albedo else (density0,)
    )
    opt_state = optimizer.init(params)
    density, albedo = density0, albedo0
    losses = []
    lo, hi = config.clip_density
    for step in range(config.n_steps):
        seed = jnp.uint32(config.seed + step * 2654435761 % (1 << 31))
        loss, grads = grad_fn(density, albedo, target, seed)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if config.optimize_albedo:
            density, albedo = params
            albedo = jnp.clip(albedo, 0.0, 1.0)
            params = (density, albedo)
        else:
            (density,) = params
        density = jnp.clip(density, lo, hi)
        params = (
            (density, albedo) if config.optimize_albedo else (density,)
        )
        losses.append(float(loss))
        if progress is not None:
            progress(step, losses[-1])
        if (
            config.checkpoint_dir
            and (step + 1) % config.checkpoint_every == 0
        ):
            _save_checkpoint(
                config.checkpoint_dir, step + 1, density, albedo,
                opt_state, seed=config.seed,
            )
    return density, albedo, losses


# ---------------------------------------------------------------------------
# Multi-view SGD + coarse-to-fine pyramid — the BASELINE config 5 recipe
# ---------------------------------------------------------------------------

def render_view_targets(
    density,
    albedo,
    scene_spec: SceneSpec,
    camera_specs: Sequence[CameraSpec],
    settings: RenderSettings,
    resolution: Tuple[int, int],
    spp: int,
    two_level: bool,
    seed: int = 999,
):
    """High-spp reference renders of the ground truth for each view.

    Targets need no gradients, so they use the fast forward renderer
    (models/fast), not render_diff — same estimator family (stochastic
    trilinear taps, two-level sparse leap), so the target is an
    unbiased image of the same transport the loss renders, at ~100x
    less cost.  This also keeps each device program short: one
    render_diff call at target spp was a single multi-minute XLA
    program that faulted the device at 256^3 (round-2 log)."""
    from . import fast  # noqa: PLC0415

    scene = scene_spec.build(density, albedo)
    tw, th = resolution
    targets = []
    for v, spec in enumerate(camera_specs):
        vs = int((seed + v * 2246822519) % (1 << 31))
        img, _ = fast.render_tile(
            scene, spec.build(), settings, (tw, th),
            jnp.zeros(2, jnp.float32), (tw, th), spp, vs, 0,
            two_level=two_level,
        )
        targets.append(img / float(spp))
    return jnp.stack(targets)


def run_inverse_views(
    targets: jnp.ndarray,  # (V, H, W, 3)
    camera_specs: Sequence[CameraSpec],
    density0: jnp.ndarray,
    albedo0: jnp.ndarray,
    scene_spec: SceneSpec,
    settings: RenderSettings,
    config: InverseConfig,
    progress: Optional[Callable[[int, float], None]] = None,
    opt_state=None,
    start_step: int = 0,
):
    """Adam over round-robin view minibatches.  Each (view, sample
    chunk) is its own short device program (traced camera — ONE
    compile serves every pose); grads are averaged across the
    config.views_per_step x config.spp_chunks programs of a step.
    Per-view splitting is exact math (the multi-view loss is a mean of
    per-view MSEs); the chunking bounds per-program execution time and
    memory.

    start_step resumes mid-run: seeds derive from (config.seed, step),
    so a run resumed at k (with the checkpointed opt_state) replays the
    unbroken run's steps k.. exactly.  Returns (density, losses,
    opt_state)."""
    import jax  # noqa: PLC0415

    n_chunks = max(1, int(config.spp_chunks))
    if config.spp % n_chunks != 0:
        raise ValueError(
            f"spp={config.spp} not divisible by spp_chunks={n_chunks}: "
            "the chunked loss would silently drop samples"
        )
    chunk_spp = max(1, config.spp // n_chunks)
    chunk_cfg = dataclasses.replace(config, spp=chunk_spp)
    loss_fn = make_view_loss_fn(
        scene_spec, camera_specs[0], settings, chunk_cfg
    )
    optimizer = optax.adam(config.learning_rate)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, argnums=0))

    cameras = [spec.build() for spec in camera_specs]
    n_views = len(cameras)
    density = density0
    losses = []
    lo, hi = config.clip_density
    if opt_state is None:
        opt_state = optimizer.init(density)
    n_parts = config.views_per_step * n_chunks
    for step in range(start_step, config.n_steps):
        views = [
            (step * config.views_per_step + j) % n_views
            for j in range(config.views_per_step)
        ]
        loss = 0.0
        grad = None
        for v in views:
            for c in range(n_chunks):
                seed = jnp.uint32(
                    (
                        config.seed
                        + step * 2654435761
                        + v * 2246822519
                        + c * 3266489917
                    )
                    % (1 << 31)
                )
                l_c, g_c = grad_fn(
                    density, albedo0, targets[v], seed, cameras[v]
                )
                loss = loss + l_c
                grad = g_c if grad is None else grad + g_c
        loss = loss / n_parts
        grad = grad / n_parts
        updates, opt_state = optimizer.update(grad, opt_state, density)
        density = jnp.clip(optax.apply_updates(density, updates), lo, hi)
        losses.append(float(loss))
        if progress is not None:
            progress(step, losses[-1])
        if (
            config.checkpoint_dir
            and (step + 1) % config.checkpoint_every == 0
        ):
            _save_checkpoint(
                config.checkpoint_dir, step + 1, density, albedo0,
                opt_state, seed=config.seed,
            )
    return density, losses, opt_state


def observability_depth(
    density: np.ndarray, scale: float, aabb_extent: float = 1.0
) -> np.ndarray:
    """Per-voxel minimal optical depth to the volume boundary.

    The identifiability criterion for the inverse problem (PERF.md,
    round-2 analysis): a voxel whose *cheapest* escape path already has
    optical depth tau >> 1 is pitch black in every view — no pixel's
    radiance depends measurably on it, so the fit cannot recover it
    (its gradient is exponentially suppressed by exp(-tau)).  We
    estimate tau by the best of the six axis-aligned exit paths.  Note
    this is an UPPER bound on the true minimal escape depth, not a
    lower bound: the true minimum is over all straight-line directions
    and a low-density channel along a non-axis direction can undercut
    every axis path.  Voxels flagged unobservable by this heuristic are
    therefore *likely* (not provably) unobservable; voxels flagged
    observable are certainly observable.  Good enough for the
    shell/interior MSE split it feeds (an analysis diagnostic — the
    renderer never uses it).

    Returns an array shaped like ``density`` of min-over-6-directions
    exclusive cumulative optical depth, in units of extinction
    (sigma_t = density * scale, voxel size = aabb_extent / n per axis).
    """
    d = np.asarray(density, np.float64)
    out = np.full(d.shape, np.inf)
    for axis in range(3):
        dx = aabb_extent / d.shape[axis]
        sig = d * scale * dx
        # exclusive cumsum from each face: depth BEFORE entering voxel
        cum = np.cumsum(sig, axis=axis) - sig
        out = np.minimum(out, cum)
        rcum = (
            np.flip(np.cumsum(np.flip(sig, axis=axis), axis=axis),
                    axis=axis) - sig
        )
        out = np.minimum(out, rcum)
    return out


def split_mse_by_observability(
    recovered: np.ndarray,
    truth: np.ndarray,
    init_value: float,
    scale: float,
    tau_c: float = 5.0,
):
    """Grid-MSE ratio (final/init) separately over the observable shell
    (min escape optical depth < tau_c) and the unobservable interior.

    Evidence form of the identifiability argument:
    at a too-large extinction scale the *shell* still converges while
    the interior stays at the prior — the divergence of the round-1
    scale-100 run was an observability problem, not an optimizer one."""
    tau = observability_depth(truth, scale)
    shell = tau < tau_c
    rec = np.asarray(recovered, np.float64)
    tr = np.asarray(truth, np.float64)
    res = {}
    for name, mask in (("shell", shell), ("interior", ~shell)):
        n = int(mask.sum())
        if n == 0:
            res[name] = {"n_voxels": 0}
            continue
        mse0 = float(((init_value - tr[mask]) ** 2).mean())
        mse1 = float(((rec[mask] - tr[mask]) ** 2).mean())
        res[name] = {
            "n_voxels": n,
            "mse_init": round(mse0, 6),
            "mse_final": round(mse1, 6),
            "mse_ratio": round(mse1 / max(mse0, 1e-12), 4),
        }
    res["tau_c"] = tau_c
    res["shell_frac"] = round(float(shell.mean()), 4)
    return res


def upsample_density(density: jnp.ndarray, shape_zyx) -> jnp.ndarray:
    """Trilinear upsampling between pyramid levels."""
    import jax  # noqa: PLC0415

    return jax.image.resize(density, shape_zyx, method="trilinear")


def run_inverse_pyramid(
    targets: jnp.ndarray,
    camera_specs: Sequence[CameraSpec],
    albedo0: jnp.ndarray,
    scene_spec: SceneSpec,
    settings: RenderSettings,
    config: InverseConfig,
    levels: Sequence[Tuple[int, int]],  # [(grid_n, n_steps), ...]
    init_value: float = 0.25,
    progress: Optional[Callable[[str, int, float], None]] = None,
    resume: bool = False,
):
    """Coarse-to-fine recovery: optimize a small grid first (cheap,
    well-conditioned — each coarse voxel pools many paths), trilinearly
    upsample, continue.  The targets are fixed full-resolution renders
    of the ground truth; only the optimized grid changes size.  This is
    the standard differentiable-volume-rendering schedule (e.g.
    Mitsuba-family inverse pipelines) and what makes the 256^3 recovery
    (BASELINE config 5) converge where single-level Adam diverges.

    Checkpoint/resume: with config.checkpoint_dir set, each level
    checkpoints into `<dir>/L<grid_n>` (including a forced final-step
    checkpoint — the upsample boundary must be replayable), and
    `resume=True` restarts from the deepest level that has a checkpoint:
    completed coarse levels are skipped, the interrupted level continues
    at its saved step with its saved Adam moments, and the seed schedule
    replays exactly (seeds derive from (config.seed, step)).  This is
    what lets a multi-hour 256^3 run survive the device faults the
    chunked programs exist for.

    Returns (density, per_level_losses)."""
    import optax  # noqa: PLC0415

    density = jnp.full(
        (levels[0][0],) * 3, init_value, jnp.float32
    )
    all_losses = []
    # resume: deepest level with any checkpoint wins
    resume_li, resume_step, resume_opt_raw = -1, 0, None
    if resume and config.checkpoint_dir:
        for li, (n, steps) in enumerate(levels):
            lvl_dir = os.path.join(config.checkpoint_dir, f"L{n}")
            latest = find_latest_checkpoint(lvl_dir)
            if latest is not None:
                resume_li, resume_step = li, latest
    for li, (n, steps) in enumerate(levels):
        lvl_dir = (
            os.path.join(config.checkpoint_dir, f"L{n}")
            if config.checkpoint_dir
            else None
        )
        if li < resume_li:
            all_losses.append([])
            continue  # completed level; the deeper checkpoint carries it
        opt_state = None
        start_step = 0
        if li == resume_li:
            optimizer = optax.adam(config.learning_rate)
            tpl = optimizer.init(jnp.zeros((n, n, n), jnp.float32))
            d_ck, _, step_ck, opt_state = load_checkpoint(
                lvl_dir, resume_step, opt_state_like=tpl
            )
            density = jnp.asarray(d_ck)
            start_step = step_ck
            if start_step >= steps:
                all_losses.append([])
                continue  # level already finished; move to the next
        elif density.shape[0] != n:
            density = jnp.clip(
                upsample_density(density, (n, n, n)),
                *config.clip_density,
            )
        lvl_cfg = dataclasses.replace(
            config, n_steps=steps, checkpoint_dir=lvl_dir
        )
        density, losses, opt_state = run_inverse_views(
            targets, camera_specs, density, albedo0, scene_spec,
            settings, lvl_cfg,
            progress=(
                None
                if progress is None
                else (lambda s, l, _n=n: progress(f"{_n}^3", s, l))
            ),
            opt_state=opt_state,
            start_step=start_step,
        )
        if lvl_dir:
            _save_checkpoint(
                lvl_dir, steps, density, albedo0, opt_state,
                seed=config.seed,
            )
        all_losses.append(losses)
    return density, all_losses
