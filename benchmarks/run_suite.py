#!/usr/bin/env python
"""Benchmark suite reproducing the reference's measurement protocol
(thesis tables 4.1-4.6, 6.2-6.3 — see BASELINE.md): kernels x scenes in
Mrays/s with discard-first-trial statistics, plus the tiling table.

Usage:
    python benchmarks/run_suite.py [--quick] [--out results.json]

Runs on the GPU only.

Scenes are synthetic stand-ins with the reference workloads' shapes
(the original volumes are LFS-stubbed): bucky-class 32^3, smoke-class
128x128x50 @ scale 800, medical-class 256^3 @ scale 100.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    parser.add_argument(
        "--tiling", action="store_true",
        help="reproduce the thesis Table 4.2 tiling protocol "
        "(1920x1920, 5 iterations, tile grids 1..64 per side)",
    )
    parser.add_argument("--out", default="benchmarks/results.json")
    parser.add_argument(
        "--kernels",
        nargs="+",
        default=["naiveSK", "regenerationSK", "streamingSK", "fastSK"],
    )
    args = parser.parse_args()

    from cudavolumerenderer_tpu.utils.device import (
        enable_compile_cache,
        require_gpu,
    )

    require_gpu()
    enable_compile_cache()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    import jax.numpy as jnp

    from cudavolumerenderer_tpu.config import Config, Kernel
    from cudavolumerenderer_tpu.models import fast
    from cudavolumerenderer_tpu.models.renderer import create_renderer
    from cudavolumerenderer_tpu.ops.camera import make_camera
    from cudavolumerenderer_tpu.scene import procedural
    from cudavolumerenderer_tpu.scene.raw_builder import albedo_from_density
    from cudavolumerenderer_tpu.scene.types import (
        RenderSettings,
        make_medium,
        make_scene,
    )

    def bucky():
        d = procedural.blob_volume((32, 32, 32))
        return make_scene(
            make_medium(d, albedo_from_density(d), scale=40.0,
                        max_density=1.0)
        )

    def smoke():
        d = procedural.smoke_volume((128, 128, 50))
        alb = np.stack([d, d, d], axis=-1) * 0.9
        return make_scene(
            make_medium(d, alb, scale=800.0, max_density=float(d.max()))
        )

    def medical():
        d = procedural.medical_volume((256, 256, 256), n_blobs=40)
        alb = np.stack([d, 0.5 * np.ones_like(d), 1.0 - d], axis=-1)
        return make_scene(
            make_medium(d, alb, scale=100.0, max_density=1.0)
        )

    if args.tiling:
        # Thesis Table 4.2 protocol: fixed 1920x1920 image, 5 iterations
        # (18.4M paths at 1 tile), sweep the tile grid; report seconds.
        # Run on the flagship scheduler (fastSK two-level).
        scene = bucky()
        res, iters = 1920, 5
        camera = make_camera(res, res)
        # All tile counts run through the batched all-tiles dispatch
        # (renderer.render -> lax.map over tile origins), so even the
        # 64x64 = 4096-tile row is ONE device program — the reference
        # pays a kernel launch per tile and degrades to 98-224 s there.
        results = {}
        for nt in (1, 2, 4, 8, 32, 64):
            config = Config(
                kernel=Kernel.FAST_SK,
                iterations=iters,
                resolution=(res, res),
                n_tiles=(nt, nt),
                two_level=True,
                settings=RenderSettings.from_flags(True),
            )
            renderer = create_renderer(scene, camera, config)
            renderer.render()  # warmup/compile for this tile shape
            t0 = time.time()
            renderer.render()
            dt = time.time() - t0
            key = f"tiling1920/fastSK-2L/{nt}x{nt}"
            results[key] = {
                "time_s": round(dt, 3),
                "paths_per_tile": (res // nt + (res % nt > 0)) ** 2 * iters,
            }
            print(f"{key}: {dt:.2f}s", flush=True)
            with open(args.out, "w") as f:  # incremental (timeout-safe)
                json.dump(results, f, indent=2)
        print(f"wrote {args.out}")
        return 0

    scenes = [
        ("bucky32", bucky, 256, 20),
        ("smoke128", smoke, 400, 4),
    ]
    if not args.quick:
        scenes.append(("medical256", medical, 512, 4))

    results = {}
    for scene_name, make, res, iters in scenes:
        scene = make()
        camera = make_camera(res, res)
        for kname in args.kernels:
            config = Config(
                kernel=Kernel.from_name(kname),
                iterations=iters,
                resolution=(res, res),
                n_lanes=1 << 17,
                settings=RenderSettings.from_flags(True),
            )
            renderer = create_renderer(scene, camera, config)
            renderer.render()  # warmup/compile
            t0 = time.time()
            renderer.render()
            dt = time.time() - t0
            mrays = renderer.n_rays / (dt * 1e6)
            key = f"{scene_name}/{kname}"
            results[key] = {
                "time_s": round(dt, 3),
                "mrays_per_sec": round(mrays, 3),
            }
            print(f"{key}: {dt:.2f}s, {mrays:.2f} Mrays/s", flush=True)

        # two-level fastSK variant (sparse-leap)
        settings = RenderSettings.from_flags(True)
        fargs = (
            scene, camera, settings, (res, res),
            jnp.zeros(2, jnp.float32), (res, res), iters, 1234, 0,
        )
        img, _ = fast.render_tile(*fargs, two_level=True)
        img.block_until_ready()
        t0 = time.time()
        img, nr = fast.render_tile(
            scene, camera, settings, (res, res),
            jnp.zeros(2, jnp.float32), (res, res), iters, 1300, 0,
            two_level=True,
        )
        img.block_until_ready()
        dt = time.time() - t0
        key = f"{scene_name}/fastSK-2L"
        results[key] = {
            "time_s": round(dt, 3),
            "mrays_per_sec": round(float(nr) / (dt * 1e6), 3),
        }
        print(f"{key}: {dt:.2f}s, {results[key]['mrays_per_sec']:.2f} "
              f"Mrays/s", flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
