#!/usr/bin/env python
"""Bring-up check of the render and gradient paths on one NVIDIA GPU.

    python chip_smoke.py           # one card: device, forward,
                                   # correctness and gradient phases
    python chip_smoke.py --four    # four cards: sharded render and
                                   # sharded inverse step only

Every phase goes through the entry points a user calls (scene loader ->
create_renderer -> render -> image on the host; render_diff and
models/inverse.py for the gradient) at the BASELINE configs' published
sizes, with scene files written from fixed seeds.  A phase that fails
prints its traceback; the script then exits 1 without a result line.
On success the last line is one JSON object naming the device.

Runs in one JAX process (a second process on the card would find most
of its memory taken).  Without a GPU it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import traceback

import numpy as np

#: GPU vs CPU image at 64^2 (same seed, same config): the two backends
#: round exp/log and fused multiply-adds differently, which can flip a
#: rare Woodcock accept/reject decision and reroute that path.  So no
#: bit equality: most pixels agree closely and the image mean agrees.
XDEV_PIXEL_RTOL, XDEV_PIXEL_ATOL = 1e-3, 1e-4
XDEV_MIN_AGREE = 0.97  # share of pixels within the tolerance above
XDEV_MEAN_RTOL = 0.02
#: GPU vs CPU gradient at 32^3 / 32^2: on top of the branch flips the
#: cotangent scatter-adds become atomics on the GPU, summed in a
#: different order on every run.  Compared as whole vectors.
XGRAD_MIN_COSINE = 0.98
XGRAD_MAX_REL_L2 = 0.2
#: fastSK vs naiveSK (independent integrator body, different filtering
#: estimator): image means agree within Monte-Carlo noise at 64^2 x 64.
STAT_MEAN_RTOL = 0.015
STAT_RAYS_RTOL = 0.05
#: four cards vs one card.  The one-card reference renders the same
#: sample set with the per-card program's shape: four 1-spp renders, one
#: per shard's path ids.  On the CPU the two agree to psum order
#: (__graft_entry__'s 2e-5).  On the GPU two separately compiled programs
#: may round differently, which can flip a rare Woodcock decision and
#: reroute one path: a whole sample in one pixel, and that path's rays.
#: Witness (one H100): the medical 512^2 x 4 sample set rendered as
#: four 1-spp programs against one 4-spp program differed in 1 pixel and
#: 229 rays, while each program repeated was bit-identical.  So the bound
#: allows flips in SHARD_FLIP_SHARE of the paths, no other difference.
SHARD_PIXEL_TOL = 2e-5  # rtol = atol: psum order
SHARD_FLIP_SHARE = 1e-4  # pixels outside SHARD_PIXEL_TOL (26 at 512^2)
SHARD_RAYS_RTOL = 1e-3  # 26 flipped paths at ~230 rays each, of 6.1M
#: the sharded step's gradient against the mean of the four device
#: gradients on one card (which repeats bit-identically there): k flipped
#: paths of N move a noise-dominated gradient by ~sqrt(2k/N) relative,
#: 1.4e-2 at the flip share above; one flipped pixel moves the 256^2 MSE
#: by ~1e-4 relative.
SHARD_GRAD_REL_L2 = 1.5e-2
SHARD_LOSS_RTOL = 3e-3


def log(msg: str) -> None:
    print(msg, flush=True)


class Smoke:
    """Runs phases, records failures, reports on the device."""

    def __init__(self, dev, stats):
        self.dev = dev
        self.stats = stats
        self.failed = []

    def phase(self, name, fn, *args, **kw):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            fn(self, *args, **kw)
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            sys.stdout.flush()
            self.failed.append(name)
            log(f"== phase {name}: FAILED")
            return
        log(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)")

    def peak_bytes(self) -> int:
        stats = self.dev.memory_stats() or {}
        return int(stats.get("peak_bytes_in_use", -1))


def check_image(name, img, shape, n_rays):
    img = np.asarray(img)
    if img.shape != shape:
        raise AssertionError(f"{name}: image shape {img.shape} != {shape}")
    if not np.isfinite(img).all():
        raise AssertionError(f"{name}: non-finite pixels")
    if not img.mean() > 0.0:
        raise AssertionError(f"{name}: image mean {img.mean()} <= 0")
    if not n_rays > 0:
        raise AssertionError(f"{name}: n_rays {n_rays} <= 0")


def timed_render(smoke, name, renderer, reps=2):
    """First render (compiles) and `reps` steady renders with fresh
    seeds; each render ends with the image on the host."""
    c0, h0, _ = smoke.stats.snapshot()
    t0 = time.perf_counter()
    img = renderer.render()
    first_s = time.perf_counter() - t0
    c1, h1, _ = smoke.stats.snapshot()
    times = []
    for _ in range(reps):
        renderer.config.seed += 1
        t0 = time.perf_counter()
        img = renderer.render()
        times.append(time.perf_counter() - t0)
    n_rays = renderer.n_rays
    w, h = renderer.config.resolution
    check_image(name, img, (h, w, 3), n_rays)
    steady = float(np.median(times))
    log(
        f"{name}: compile_s={c1 - c0:.2f} cache_hits={h1 - h0} "
        f"first_call_s={first_s:.2f} render_s={steady:.4f} "
        f"(reps {', '.join(f'{t:.4f}' for t in times)}) "
        f"n_rays={n_rays:.0f} mrays_per_s={n_rays / steady / 1e6:.3f} "
        f"image_mean={float(np.mean(img)):.6f} "
        f"peak_bytes_in_use={smoke.peak_bytes()} "
        f"device={smoke.dev.device_kind}"
    )
    return img


def phase_forward(smoke, tmp, quick=False):
    """The four BASELINE forward configs through their file loaders,
    then the 1024^3 sparse plume, each fastSK two-level f32."""
    from benchmarks.baseline_configs import CONFIGS, make_config
    from cudavolumerenderer_tpu.models.renderer import create_renderer
    from cudavolumerenderer_tpu.scene.loader import load_scene

    for name, writer, res, iters, tiles, _ in CONFIGS:
        if quick:
            res, iters = 40, min(iters, 2)
        config = make_config(writer(tmp), res, iters, tiles)
        t0 = time.perf_counter()
        scene, camera = load_scene(config)
        renderer = create_renderer(scene, camera, config)
        log(f"{name}: load_s={time.perf_counter() - t0:.2f} "
            f"grid={tuple(scene.medium.density.data.shape)}")
        timed_render(smoke, name, renderer)
    phase_plume(smoke, n=64 if quick else 1024, res=32 if quick else 512)


def phase_plume(smoke, n, res):
    """bench_1024's generator: the grid is built on the device."""
    from benchmarks.baseline_configs import make_config
    from benchmarks.bench_1024 import make_density_1024
    from cudavolumerenderer_tpu.models.renderer import create_renderer
    from cudavolumerenderer_tpu.ops.camera import make_camera
    from cudavolumerenderer_tpu.scene.types import make_medium, make_scene

    t0 = time.perf_counter()
    density = make_density_1024(n)
    dmax = float(density.max())
    scene = make_scene(
        make_medium(density, (0.9, 0.9, 0.9), scale=100.0, max_density=dmax)
    )
    config = make_config(None, res, 1, (1, 1))
    renderer = create_renderer(scene, make_camera(res, res), config)
    log(f"5_plume_{n}: build_s={time.perf_counter() - t0:.2f} "
        f"table_bytes={density.size * 4}")
    timed_render(smoke, f"5_plume_{n}_{res}", renderer, reps=1)


def _blob_scene(albedo_value=None):
    from cudavolumerenderer_tpu.scene import procedural
    from cudavolumerenderer_tpu.scene.types import make_medium, make_scene

    dens = procedural.blob_volume()
    if albedo_value is None:
        albedo = np.stack(
            [dens, 0.5 * np.ones_like(dens), 1.0 - dens], axis=-1
        )
    else:
        albedo = np.full(dens.shape + (3,), albedo_value, np.float32)
    return make_scene(make_medium(dens, albedo, scale=40.0, max_density=1.0))


def _render(kernel, res, spp, settings=None, albedo_value=None, seed=11):
    """One create_renderer render of the blob scene on JAX's current
    default device; returns (image, n_rays)."""
    from cudavolumerenderer_tpu.config import Config, Kernel
    from cudavolumerenderer_tpu.models.renderer import create_renderer
    from cudavolumerenderer_tpu.ops.camera import make_camera
    from cudavolumerenderer_tpu.scene.types import RenderSettings

    config = Config(
        kernel=Kernel.from_name(kernel), iterations=spp,
        resolution=(res, res), two_level=True, seed=seed,
        settings=settings or RenderSettings.from_flags(True),
    )
    renderer = create_renderer(
        _blob_scene(albedo_value), make_camera(res, res), config
    )
    img = renderer.render()
    return img, renderer.n_rays


def phase_correctness(smoke, quick=False):
    import jax

    from cudavolumerenderer_tpu.scene.types import RenderSettings

    res = 16 if quick else 64
    # white furnace: albedo 1 + pass-through boundary conserves energy
    furnace = RenderSettings.from_flags(True, bsdf_kind="null")
    img, _ = _render("fastSK", res, 8, furnace, albedo_value=1.0)
    err = float(np.abs(img - 1.0).max())
    log(f"furnace {res}^2 x 8: max |pixel - 1| = {err:.3e} (bound 1e-5)")
    if not err <= 1e-5:
        raise AssertionError("white furnace is not 1.0")

    # the same render on the GPU and on the host CPU
    img_g, rays_g = _render("fastSK", res, 4)
    with jax.default_device(jax.devices("cpu")[0]):
        img_c, rays_c = _render("fastSK", res, 4)
    close = np.isclose(
        img_g, img_c, rtol=XDEV_PIXEL_RTOL, atol=XDEV_PIXEL_ATOL
    ).all(axis=-1)
    agree = float(close.mean())
    mean_rel = abs(img_g.mean() - img_c.mean()) / img_c.mean()
    log(
        f"gpu vs cpu {res}^2 x 4: pixels agreeing {agree:.4f} "
        f"(bound >= {XDEV_MIN_AGREE}), mean rel diff {mean_rel:.2e} "
        f"(bound {XDEV_MEAN_RTOL}), max |diff| "
        f"{float(np.abs(img_g - img_c).max()):.3e}, "
        f"rays {rays_g:.0f} vs {rays_c:.0f}"
    )
    if not (agree >= XDEV_MIN_AGREE and mean_rel <= XDEV_MEAN_RTOL):
        raise AssertionError("GPU and CPU images disagree")

    # fastSK against naiveSK, an independent integrator body
    spp = 16 if quick else 64
    img_f, rays_f = _render("fastSK", res, spp)
    img_n, rays_n = _render("naiveSK", res, spp)
    mean_rel = abs(img_f.mean() - img_n.mean()) / img_n.mean()
    rays_rel = abs(rays_f - rays_n) / rays_n
    log(
        f"fastSK vs naiveSK {res}^2 x {spp}: mean rel diff {mean_rel:.2e} "
        f"(bound {STAT_MEAN_RTOL}), rays rel diff {rays_rel:.2e} "
        f"(bound {STAT_RAYS_RTOL})"
    )
    if not (mean_rel <= STAT_MEAN_RTOL and rays_rel <= STAT_RAYS_RTOL):
        raise AssertionError("fastSK and naiveSK disagree")


def _inverse_problem(n, res, target_spp=16):
    """BASELINE config 5's shape (benchmarks/inverse_256.py): medical
    phantom, albedo 0.6, scale 12, RR off, one view."""
    import jax.numpy as jnp

    from cudavolumerenderer_tpu.models import inverse
    from cudavolumerenderer_tpu.models.differentiable import (
        CameraSpec,
        SceneSpec,
    )
    from cudavolumerenderer_tpu.scene import procedural
    from cudavolumerenderer_tpu.scene.types import RenderSettings

    gt = jnp.asarray(procedural.medical_volume((n, n, n), n_blobs=40))
    albedo = jnp.full((1, 1, 1, 4), 0.6, jnp.float32)
    spec = SceneSpec(scale=12.0, max_density=1.0)
    settings = RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=64
    )
    cam = CameraSpec(res_x=res, res_y=res, fov_x_deg=0.8)
    target = inverse.render_view_targets(
        gt, albedo, spec, [cam], settings, (res, res), target_spp, True
    )[0]
    return gt, albedo, spec, settings, cam, target


def _grad_fn(spec, settings, cam, res, spp):
    """jit(value_and_grad) of one device's inverse loss, the MSE of an
    spp-sample two-level render_diff image (the loss each device of
    parallel/shard.make_inverse_step computes)."""
    import jax
    import jax.numpy as jnp

    from cudavolumerenderer_tpu.models.differentiable import render_diff

    def loss(density, albedo, target, seed):
        img = render_diff(
            density, albedo, seed, spec, cam, settings, (res, res), spp,
            True,
        ) / float(spp)
        return jnp.mean((img - target) ** 2)

    return jax.jit(jax.value_and_grad(loss))


def _device_seed(seed, device_index):
    """Device `device_index`'s seed in parallel/shard.make_inverse_step:
    the step seed salted with the golden-ratio constant."""
    import jax.numpy as jnp

    return jnp.asarray(seed, jnp.uint32) + jnp.uint32(
        device_index
    ) * jnp.uint32(0x9E3779B9)


def phase_gradient(smoke, quick=False):
    import jax
    import jax.numpy as jnp

    from cudavolumerenderer_tpu.models import inverse

    n, res, spp = (32, 32, 1) if quick else (256, 256, 1)
    gt, albedo, spec, settings, cam, target = _inverse_problem(n, res)
    vg = _grad_fn(spec, settings, cam, res, spp)
    density0 = jnp.full_like(gt, 0.25)
    seed = jnp.uint32(5)
    c0, _, _ = smoke.stats.snapshot()
    t0 = time.perf_counter()
    loss, g = vg(density0, albedo, target, seed)
    g = np.asarray(g)
    first_s = time.perf_counter() - t0
    c1, _, _ = smoke.stats.snapshot()
    t0 = time.perf_counter()
    loss, g = vg(density0, albedo, target, seed + 1)
    g = np.asarray(g)
    grad_s = time.perf_counter() - t0
    log(
        f"render_diff two-level {n}^3 at {res}^2 x {spp}: "
        f"compile_s={c1 - c0:.2f} first_call_s={first_s:.2f} "
        f"grad_s={grad_s:.4f} loss={float(loss):.6e} "
        f"|g|={float(np.linalg.norm(g)):.3e} nonzero={int((g != 0).sum())} "
        f"peak_bytes_in_use={smoke.peak_bytes()} "
        f"device={smoke.dev.device_kind}"
    )
    if not (np.isfinite(float(loss)) and np.isfinite(g).all()):
        raise AssertionError("non-finite loss or gradient")
    if not np.any(g != 0):
        raise AssertionError("gradient is identically zero")

    # the trainer: three Adam steps of models/inverse.run_inverse
    config = inverse.InverseConfig(
        resolution=(res, res), spp=spp, learning_rate=0.05, n_steps=3,
        seed=17, two_level=True,
    )
    t0 = time.perf_counter()
    density, _, losses = inverse.run_inverse(
        target, density0, albedo, spec, cam, settings, config
    )
    log(f"run_inverse 3 Adam steps: losses={losses} "
        f"wall_s={time.perf_counter() - t0:.2f}")
    if not (np.isfinite(losses).all() and jnp.isfinite(density).all()):
        raise AssertionError("non-finite inverse step")

    # the same gradient on the GPU and on the host CPU
    g_dev = np.asarray(_value_and_grad_at(jax.devices()[0]))
    g_cpu = np.asarray(_value_and_grad_at(jax.devices("cpu")[0]))
    cos = float(
        (g_dev * g_cpu).sum()
        / (np.linalg.norm(g_dev) * np.linalg.norm(g_cpu))
    )
    rel = float(np.linalg.norm(g_dev - g_cpu) / np.linalg.norm(g_cpu))
    log(
        f"gpu vs cpu gradient 32^3 at 32^2 x 4: cosine {cos:.5f} "
        f"(bound >= {XGRAD_MIN_COSINE}), rel L2 {rel:.3e} "
        f"(bound {XGRAD_MAX_REL_L2})"
    )
    if not (cos >= XGRAD_MIN_COSINE and rel <= XGRAD_MAX_REL_L2):
        raise AssertionError("GPU and CPU gradients disagree")


def _value_and_grad_at(device):
    """Gradient of the 32^3 / 32^2 x 4 inverse loss, computed on
    `device` (problem data made there too)."""
    import jax
    import jax.numpy as jnp

    with jax.default_device(device):
        gt, albedo, spec, settings, cam, target = _inverse_problem(32, 32)
        vg = _grad_fn(spec, settings, cam, 32, 4)
        _, g = vg(jnp.full_like(gt, 0.25), albedo, target, jnp.uint32(5))
        return g


def _mesh4():
    import jax

    from cudavolumerenderer_tpu.parallel.mesh import make_mesh

    if len(jax.devices()) < 4:
        raise AssertionError(f"need 4 devices, have {len(jax.devices())}")
    return make_mesh(4)


def phase_four_render(smoke, tmp, quick=False):
    """Sharded fastSK render of the medical config on four cards against
    the same sample set on one card."""
    import jax.numpy as jnp

    from benchmarks.baseline_configs import make_config, write_medical_mhd
    from cudavolumerenderer_tpu.models import fast
    from cudavolumerenderer_tpu.parallel.shard import render_sharded
    from cudavolumerenderer_tpu.scene.loader import load_scene

    mesh = _mesh4()

    # medical config (BASELINE 2), 4 spp: one sample per card
    res = 64 if quick else 512
    n_pix = res * res
    config = make_config(write_medical_mhd(tmp), res, 4, (1, 1))
    scene, camera = load_scene(config)
    knobs = dict(two_level=True, cascade_factor=config.cascade_factor)

    def sharded():
        img, rays = render_sharded(
            scene, camera, config.settings, (res, res), spp=4, seed=7,
            mesh=mesh, kernel="fast", **knobs,
        )
        return np.asarray(img), float(rays)

    t0 = time.perf_counter()
    img4, rays4 = sharded()
    t4 = time.perf_counter() - t0
    img4b, rays4b = sharded()
    # the same sample set on one card: shard i's path ids, 1 spp each
    t0 = time.perf_counter()
    img1, rays1 = np.zeros_like(img4), 0.0
    for i in range(4):
        img, rays = fast.render_tile(
            scene, camera, config.settings, (res, res),
            jnp.zeros(2, jnp.float32), (res, res), 1, 7,
            jnp.uint32(i * n_pix), **knobs,
        )
        img1 += np.asarray(img)
        rays1 += float(rays)
    t1 = time.perf_counter() - t0
    check_image("sharded medical", img4, (res, res, 3), rays4)
    flipped = np.argwhere(~np.isclose(
        img4, img1, rtol=SHARD_PIXEL_TOL, atol=SHARD_PIXEL_TOL
    ).all(axis=-1))
    flip_share = len(flipped) / n_pix
    rays_rel = abs(rays4 - rays1) / rays1
    log(
        f"render_sharded medical {res}^2 x 4 on 4 cards vs the same "
        f"samples as 4 x 1 spp on 1 card: pixels outside {SHARD_PIXEL_TOL} "
        f"{len(flipped)} of {n_pix} (share {flip_share:.2e}, bound "
        f"{SHARD_FLIP_SHARE}) at {flipped[:8].tolist()}, max |diff| "
        f"{float(np.abs(img4 - img1).max()):.3e}, mean rel diff "
        f"{abs(img4.mean() - img1.mean()) / img1.mean():.2e}, rays "
        f"{rays4:.0f} vs {rays1:.0f} (rel {rays_rel:.2e}, bound "
        f"{SHARD_RAYS_RTOL}); repeat on 4 cards bit-identical: "
        f"{bool((img4b == img4).all() and rays4b == rays4)} (first calls, "
        f"compile included: {t4:.1f} s vs {t1:.1f} s)"
    )
    if not (flip_share <= SHARD_FLIP_SHARE and rays_rel <= SHARD_RAYS_RTOL):
        raise AssertionError("sharded render disagrees with one card")


def _capture_grads():
    """An optax transformation that leaves the parameters unchanged and
    keeps the step's gradients as its state, so a step's gradients are
    read back exactly."""
    import jax
    import jax.numpy as jnp
    import optax

    def zeros(tree):
        return jax.tree.map(jnp.zeros_like, tree)

    return optax.GradientTransformation(
        zeros, lambda grads, state, params=None: (zeros(grads), grads)
    )


def phase_four_inverse(smoke, quick=False):
    """One sharded inverse step on four cards against the four
    per-device gradients computed on one card."""
    import jax.numpy as jnp

    from cudavolumerenderer_tpu.parallel.shard import make_inverse_step

    mesh = _mesh4()
    # at the gradient phase's size, so the one-card program can come
    # from the cache
    n, gres = (32, 32) if quick else (256, 256)
    gt, albedo, spec, settings, cam, target = _inverse_problem(n, gres)
    density = jnp.full_like(gt, 0.25)
    seed = jnp.uint32(23)
    capture = _capture_grads()
    step = make_inverse_step(
        spec, cam, settings, (gres, gres), spp_per_device=1, mesh=mesh,
        optimizer=capture, two_level=True,
    )
    params = (density, albedo)
    t0 = time.perf_counter()
    _, (g4, _), loss4 = step(params, capture.init(params), target, seed)
    g4, loss4 = np.asarray(g4), float(loss4)
    t4 = time.perf_counter() - t0
    vg = _grad_fn(spec, settings, cam, gres, 1)
    parts = [vg(density, albedo, target, _device_seed(seed, i))
             for i in range(4)]
    loss1 = float(np.mean([float(p[0]) for p in parts]))
    g1 = np.mean([np.asarray(p[1]) for p in parts], axis=0)
    if not (np.isfinite(g4).all() and np.isfinite(loss4)):
        raise AssertionError("non-finite sharded inverse step")
    rel = float(np.linalg.norm(g4 - g1) / np.linalg.norm(g1))
    loss_rel = abs(loss4 - loss1) / loss1
    log(
        f"make_inverse_step {n}^3 at {gres}^2 on 4 cards vs the mean of "
        f"4 device gradients on 1 card: gradient rel L2 {rel:.3e} (bound "
        f"{SHARD_GRAD_REL_L2}), loss {loss4:.6e} vs {loss1:.6e} (rel "
        f"{loss_rel:.2e}, bound {SHARD_LOSS_RTOL}), |g| "
        f"{float(np.linalg.norm(g4)):.3e} (first call, compile included: "
        f"{t4:.1f} s)"
    )
    if not (rel <= SHARD_GRAD_REL_L2 and loss_rel <= SHARD_LOSS_RTOL):
        raise AssertionError("sharded inverse step disagrees with one card")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the four-card phase (sharded render and inverse "
        "step against one card)",
    )
    args = parser.parse_args(argv)

    import jax

    from cudavolumerenderer_tpu.utils.device import (
        CompileStats,
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    dev = require_gpu()
    cache_dir = enable_compile_cache()
    stats = CompileStats()
    smi = gpu_name_and_power_limit()
    log(
        f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} jax={jax.__version__} "
        f"compile_cache={cache_dir}"
    )
    log(f"nvidia-smi: {smi}")

    smoke = Smoke(dev, stats)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.four:
            smoke.phase("four_render", phase_four_render, tmp)
            smoke.phase("four_inverse", phase_four_inverse)
        else:
            smoke.phase("forward", phase_forward, tmp)
            smoke.phase("correctness", phase_correctness)
            smoke.phase("gradient", phase_gradient)
    compile_s, hits, misses = stats.snapshot()
    log(f"compile totals: backend_compile_s={compile_s:.2f} "
        f"cache_hits={hits} cache_misses={misses}")
    if smoke.failed:
        log(f"FAILED phases: {', '.join(smoke.failed)}")
        return 1
    log(f"card: {smi}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
