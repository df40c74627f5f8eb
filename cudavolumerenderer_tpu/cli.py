"""Command-line entry point mirroring the reference's flags.

Replaces Main.cpp + ConfigParser (reference: implementation/src/Main.cpp:133,
implementation/src/ConfigParser.cpp:10-67): same flag names and defaults,
with the batch "test" mode's trials/timing/Mrays protocol
(Main.cpp:46-121).  The interactive GLFW mode becomes `--interactive`
offline progressive rendering with periodic frame dumps.

Usage:
    python -m cudavolumerenderer_tpu.cli scene.xml -k regenerationSK -i 50
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Optional

import numpy as np

from .config import Algorithm, Config, Kernel, SceneType
from .models.renderer import create_renderer
from .scene.loader import load_scene
from .utils.device import enable_compile_cache
from .utils.image import save_hdr, save_png, tonemap

PRINT_PREFIX = "[cvr] "
# Interactive-mode per-frame refinement budget in seconds (reference:
# InteractiveRenderer.h:335-343 refines until >=0.1 s has elapsed).
FRAME_BUDGET_S = 0.1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cudavolumerenderer_tpu",
        description="volumetric path tracer (JAX)",
    )
    p.add_argument("scene_file", nargs="?", help="scene file to parse")
    p.add_argument(
        "--scene-type",
        default="Auto",
        choices=["Auto", "MitsubaXml", "Vdb", "Raw", "Mhd", "Npz"],
    )
    p.add_argument(
        "--interactive",
        type=lambda s: s.lower() in ("1", "true", "yes"),
        default=False,
        help="progressive mode with periodic frame dumps "
        "(offline replacement for the GLFW view)",
    )
    p.add_argument("--trials", type=int, default=1)
    p.add_argument("-a", "--algorithm", default="cudaVolPath")
    p.add_argument(
        "-k", "--kernel", default="fastSK",
        help="scheduler; the reference defaulted to its fastest "
        "(regenerationSK) — ours is fastSK (see ARCHITECTURE.md)",
    )
    p.add_argument(
        "--number-of-tiles", type=int, nargs="+", default=[1, 1]
    )
    p.add_argument("-i", "--iterations", type=int, default=20)
    p.add_argument("-o", "--output", default=None)
    p.add_argument(
        "-r", "--resolution", type=int, nargs="+", default=[1024, 1024]
    )
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument(
        "--n-lanes", type=int, default=None,
        help="wavefront pool size for regeneration/streaming schedulers "
        "(default: auto-tuned from work size and device memory)",
    )
    p.add_argument(
        "--regeneration-level", type=int, default=0, choices=[0, 1, 2],
        help="regeneration granularity: 0=per-lane (thread), 1=per-8-lane "
        "group (warp analog), 2=per-1024-lane row (block analog)",
    )
    p.add_argument(
        "--mitsuba-comparable",
        type=lambda s: s.lower() in ("1", "true", "yes"),
        default=True,
    )
    p.add_argument(
        "--platform", default=None, choices=["cpu", "gpu"],
        help="force a JAX platform (like JAX_PLATFORMS; gpu = cuda)",
    )
    p.add_argument(
        "--two-level", action="store_true",
        help="two-level sparse-leap tracking (fastSK/fastQ): faster on "
        "sparse or high-density-scale scenes",
    )
    p.add_argument(
        "--lanes-per-pixel", type=int, default=1,
        help="fastSK: parallel sample lanes per pixel (>1 drains the "
        "cascade sooner on deep-scattering scenes)",
    )
    p.add_argument(
        "--defer-ggx", type=int, default=0,
        help="fastSK: batch boundary GGX events every G iterations "
        "(bit-exact; 0 = inline)",
    )
    p.add_argument(
        "--brick-major", action="store_true",
        help="fastSK: (8,8,128) brick-major flat-table layout for "
        "giant grids",
    )
    def _cascade_factor(v: str) -> float:
        f = float(v)
        if f <= 1.0:
            raise argparse.ArgumentTypeError(
                f"--cascade-factor must be > 1 (got {f}): values <= 1 "
                "would disable the cascade or divide by zero"
            )
        return f

    p.add_argument(
        "--cascade-factor", type=_cascade_factor, default=2,
        help="fastSK: cascade pool shrink factor (may be fractional, "
        "e.g. 1.25 — finer steps compact idle lanes out earlier near "
        "full width at the cost of more compactions; must be > 1)",
    )
    p.add_argument(
        "--table-bits", type=int, default=32, choices=[32, 8, 4],
        help="fastSK: quantized packed density table (8/4 bits per "
        "voxel; 4-8x smaller gathers; REDUCED PRECISION — acceptance "
        "bias bounded by 1/(2^(bits+1)-2) of max_density; ignored "
        "under --mitsuba-comparable unless --allow-quantized)",
    )
    p.add_argument(
        "--boundary", default="aabb", choices=["aabb", "variable"],
        help="medium boundary model: 'variable' = stochastic "
        "density-isosurface march with gradient shading normals "
        "(reference Medium.h VariableBoundary; integrator-family "
        "kernels only)",
    )
    p.add_argument(
        "--boundary-threshold", type=float, default=1e-8,
        help="gradient-magnitude threshold for --boundary variable",
    )
    p.add_argument(
        "--allow-quantized", action="store_true",
        help="opt in to quantized density tables (--table-bits < 32) "
        "while keeping --mitsuba-comparable trilinear filtering and "
        "conventions; the estimator is reduced-precision",
    )
    p.add_argument(
        "--tail-single-level", action="store_true",
        help="fastSK: tail pools use global-majorant tracking with "
        "--tail-spec speculative steps per gather",
    )
    p.add_argument(
        "--tail-spec", type=int, default=1,
        help="fastSK: speculative Woodcock steps per tail body",
    )
    p.add_argument(
        "--spec-width", type=int, default=None,
        help="fastSK: pool width below which the speculative/"
        "single-level tail modes engage",
    )
    p.add_argument(
        "--min-width", type=int, default=None,
        help="fastSK: cascade bottom pool width (quantized to "
        "multiples of 256 — values below 256 are equivalent to 256)",
    )
    p.add_argument(
        "--max-bricks", type=int, default=None,
        help="fastSK: two-level probe-table size cap (coarser bricks "
        "= fewer brick-transit rows; default 65536)",
    )
    p.add_argument(
        "--tail-bricks", type=int, default=0,
        help="fastSK: finer brick granularity for tail pools (0=off)",
    )
    p.add_argument(
        "--orbit", type=int, default=0, metavar="N",
        help="with --interactive: render N frames orbiting the volume "
        "(offline replacement for the GLFW rotate control)",
    )
    p.add_argument(
        "--camera-path", metavar="FILE", default=None,
        help="with --interactive: replay a scripted camera path "
        "(rotate/zoom/pan/lookat/render events; motion resets the "
        "progressive accumulation exactly like the reference's "
        "mouse-dirty -> reset flow)",
    )
    return p


def config_from_args(args) -> Config:
    from .scene.types import RenderSettings

    tiles = args.number_of_tiles
    if len(tiles) == 1:
        tiles = [tiles[0], tiles[0]]
    res = args.resolution
    if len(res) == 1:
        res = [res[0], res[0]]
    config = Config(
        scene_file=args.scene_file,
        scene_type=SceneType[
            {
                "Auto": "AUTO", "MitsubaXml": "MITSUBA_XML", "Vdb": "VDB",
                "Raw": "RAW", "Mhd": "MHD", "Npz": "NPZ",
            }[args.scene_type]
        ],
        algorithm=Algorithm(args.algorithm),
        kernel=Kernel.from_name(args.kernel),
        iterations=args.iterations,
        resolution=(res[0], res[1]),
        n_tiles=(tiles[0], tiles[1]),
        trials=args.trials,
        interactive=args.interactive,
        output_name=args.output,
        seed=args.seed,
        n_lanes=args.n_lanes,
        regeneration_level=args.regeneration_level,
        two_level=args.two_level,
        lanes_per_pixel=args.lanes_per_pixel,
        defer_ggx=args.defer_ggx,
        brick_major=args.brick_major,
        cascade_factor=args.cascade_factor,
        table_bits=args.table_bits,
        allow_quantized=args.allow_quantized,
        tail_single_level=args.tail_single_level,
        tail_spec=args.tail_spec,
        spec_width=args.spec_width,
        min_width=args.min_width,
        max_bricks=args.max_bricks,
        tail_bricks=args.tail_bricks,
        settings=RenderSettings.from_flags(
            args.mitsuba_comparable,
            boundary=args.boundary,
            boundary_threshold=args.boundary_threshold,
        ),
    )
    if config.output_name is None:
        config.output_name = config.to_string()
    return config


def run_test(config: Config) -> dict:
    """Batch benchmark mode (reference: runTest, Main.cpp:46-121):
    N trials, discard-first-trial mean/std, paths/s and Mrays/s."""
    times: List[float] = []
    rays: List[float] = []
    result: dict = {}
    for trial in range(config.trials):
        print(f"{PRINT_PREFIX}--- trial {trial}")
        t0 = time.time()
        scene, camera = load_scene(config)
        renderer = create_renderer(scene, camera, config)
        t1 = time.time()
        print(f"{PRINT_PREFIX}initialization time : {t1 - t0:.2f} sec")

        t0 = time.time()
        renderer.render_device()
        _ = renderer.n_rays  # on-device scalar readback = full fence
        t1 = time.time()
        # Image download OUTSIDE the timed region: the reference's
        # runTest times the render phase apart from image save
        # (Main.cpp:64-97).
        image = renderer.get_image()
        elapsed = t1 - t0
        print(f"{PRINT_PREFIX}rendering time      : {elapsed:.2f} sec")
        if trial > 0 or config.trials == 1:
            times.append(elapsed)
            rays.append(renderer.n_rays)

        save_hdr(config.output_name + ".hdr", image)
        save_png(config.output_name + ".png", tonemap(image))

    mean_time = float(np.mean(times))
    std_time = float(np.std(times))
    n_paths = (
        config.resolution[0] * config.resolution[1] * config.iterations
    )
    mrays = float(np.mean(rays)) / (mean_time * 1e6)
    print(
        f"{PRINT_PREFIX}execution mean time of {mean_time:.2f} sec on "
        f"{len(times)} trials and std {std_time:.5f}"
    )
    print(f"{PRINT_PREFIX}paths per sec {n_paths / mean_time:.0f}")
    print(f"{PRINT_PREFIX}millions of rays per sec {mrays:.3f}")
    result.update(
        mean_time=mean_time, std_time=std_time,
        paths_per_sec=n_paths / mean_time, mrays_per_sec=mrays,
    )
    return result


def run_camera_path(config: Config, path_file: str) -> None:
    """Scripted interactive-camera replay: rotate/zoom/pan events drive
    the quaternion CameraController (Camera.h:74-122 dynamics) and any
    motion resets the progressive accumulation before the next render —
    the InputController dirty-flag → reset() → initRendering flow
    (InteractiveRenderer.h:102,251-282,314-317), minus the GLFW window
    (BASELINE sanctions the offline replacement)."""
    from .ops.camera_controller import CameraController, parse_camera_path

    scene, _ = load_scene(config)
    w, h = config.resolution
    with open(path_file) as f:
        events = parse_camera_path(f.read())
    ctl = CameraController(w, h, fov_x_deg=0.7)
    renderer = create_renderer(scene, ctl.camera(), config)
    frame = 0
    for op, args in events:
        if op == "rotate":
            ctl.rotate(*args)
        elif op == "zoom":
            ctl.zoom(*args)
        elif op == "pan":
            ctl.pan(*args)
        elif op == "lookat":
            ctl.look_at(args[0:3], args[3:6], (0.0, 1.0, 0.0))
        elif op == "render":
            if ctl.consume_dirty():
                # motion invalidates the accumulated image: rebuild the
                # camera and restart accumulation (reference reset())
                renderer.camera = ctl.camera()
                renderer.init_rendering()
                print(f"{PRINT_PREFIX}camera moved, accumulation reset")
            for _ in range(args[0]):
                renderer.run_pass(1)
            frame += 1
            save_png(
                f"{config.output_name}_path{frame:04d}.png",
                tonemap(renderer.get_image()),
            )
            print(
                f"{PRINT_PREFIX}path frame {frame} dumped "
                f"({int(renderer.iterations_done.min())} it)"
            )


def run_interactive(config: Config, orbit: int = 0) -> None:
    """Offline progressive mode: refine and dump frames periodically
    (replaces GLViewController's 0.1 s refinement budget loop,
    InteractiveRenderer.h:319-349).  With orbit > 0, the camera circles
    the volume between frames — the offline stand-in for the reference's
    mouse rotate/zoom (CameraController, InteractiveRenderer.h:241-274)."""
    import math

    import numpy as np

    from .ops.camera import make_camera_look_at

    scene, camera = load_scene(config)

    if orbit > 0:
        radius = 100.0
        w, h = config.resolution
        for frame in range(orbit):
            angle = 2.0 * math.pi * frame / orbit
            eye = (
                radius * math.sin(angle), 0.0, radius * math.cos(angle)
            )
            cam_f = make_camera_look_at(
                eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), w, h, 0.7
            )
            renderer = create_renderer(scene, cam_f, config)
            img = renderer.render()
            save_png(
                f"{config.output_name}_orbit{frame:04d}.png", tonemap(img)
            )
            print(f"{PRINT_PREFIX}orbit frame {frame} dumped")
        return

    renderer = create_renderer(scene, camera, config)
    frame = 0
    while not renderer.image_complete():
        # Time-budgeted refinement, matching the reference's frame loop
        # (InteractiveRenderer.h:335-343: repeat runIterations+getImage
        # until >=0.1 s has elapsed, then present).  Each inner pass is
        # one full-image spp; batchable kernels run all tiles in a
        # single device dispatch (renderer.run_pass).
        t0 = time.time()
        while True:
            renderer.run_pass(1)
            if (
                time.time() - t0 >= FRAME_BUDGET_S
                or renderer.image_complete()
            ):
                break
        frame += 1
        save_png(
            f"{config.output_name}_frame{frame:04d}.png",
            tonemap(renderer.get_image()),
        )
        print(f"{PRINT_PREFIX}frame {frame} dumped")
    save_hdr(config.output_name + ".hdr", renderer.get_image())


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.scene_file is None:
        build_parser().print_help()
        return 2
    import jax

    if args.platform is not None:
        # "gpu" is JAX's alias for cuda AND rocm, and naming a platform
        # makes JAX fail when any of them is missing: ask for cuda
        jax.config.update(
            "jax_platforms", {"cpu": "cpu", "gpu": "cuda"}[args.platform]
        )
    enable_compile_cache()
    config = config_from_args(args)
    print(f"{PRINT_PREFIX}algorithm set to {config.algorithm.value}.")
    print(f"{PRINT_PREFIX}kernel set to {config.kernel.value}.")
    print(f"{PRINT_PREFIX}iterations set to {config.iterations}.")
    if config.interactive and args.camera_path:
        run_camera_path(config, args.camera_path)
    elif config.interactive:
        run_interactive(config, orbit=args.orbit)
    else:
        run_test(config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
