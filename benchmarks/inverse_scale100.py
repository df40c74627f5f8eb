#!/usr/bin/env python
"""Recoverability at the medical-class extinction scale=100: turn the
round-2 identifiability *assertion* into evidence.

Round 1's 256^3 scale-100 inverse run diverged (grid_mse_ratio 1.27);
round 2 argued the cause is observability, not optimization: at
scale=100 the phantom's center-line optical depth is ~57, so interior
voxels are pitch black in every view and carry exponentially-suppressed
gradients.  This driver demonstrates that claim directly: it runs the
*same converging recipe* (multi-view orbit targets, RR off, albedo 0.6,
coarse-to-fine pyramid, TV prior) at scale=100 and then splits the
grid-MSE by the identifiability criterion

    tau_min(v) = min over 6 axis exit paths of the optical depth
                 from voxel v to the boundary
                 (an axis-path heuristic: an UPPER bound on the true
                 minimal escape depth — see observability_depth)

into the observable shell (tau_min < tau_c) and the unobservable
interior (tau_min >= tau_c).  Expected result: the shell's MSE ratio
drops well below 1 while the interior stays at (or drifts from) the
prior — scale 100 is recoverable exactly where the physics says it can
be.  Runs on the GPU only.

Reference match: BASELINE config 5's medical framing; the recipe is
benchmarks/inverse_256.py's with the scale flag at 100.
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=64)
    parser.add_argument("--res", type=int, default=64)
    parser.add_argument("--views", type=int, default=6)
    parser.add_argument("--spp", type=int, default=8)
    parser.add_argument("--target-spp", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument("--scale", type=float, default=100.0)
    parser.add_argument("--tau-c", type=float, default=5.0)
    parser.add_argument("--tv", type=float, default=2e-3)
    parser.add_argument("--steps", type=int, nargs="+", default=[30, 20, 15])
    parser.add_argument("--out", default=None,
                        help="also write the result JSON here")
    args = parser.parse_args()

    from cudavolumerenderer_tpu.utils.device import (
        enable_compile_cache,
        require_gpu,
    )

    require_gpu()
    enable_compile_cache()
    import jax.numpy as jnp

    from cudavolumerenderer_tpu.models.differentiable import SceneSpec
    from cudavolumerenderer_tpu.models import inverse
    from cudavolumerenderer_tpu.scene import procedural
    from cudavolumerenderer_tpu.scene.types import RenderSettings

    n = args.n
    gt = jnp.asarray(procedural.medical_volume((n, n, n), n_blobs=40))
    albedo = jnp.full((1, 1, 1, 4), 0.6, jnp.float32)

    spec = SceneSpec(scale=args.scale, max_density=1.0)
    settings = RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=64
    )
    res = (args.res, args.res)
    views = inverse.orbit_camera_specs(
        args.views, radius=100.0, res=res, fov_x_deg=0.8
    )

    t0 = time.time()
    targets = inverse.render_view_targets(
        gt, albedo, spec, views, settings, res, args.target_spp, True
    )
    targets.block_until_ready()
    t_targets = time.time() - t0
    print(f"targets: {args.views} views x {args.target_spp} spp, "
          f"{t_targets:.1f}s", flush=True)

    levels = [(n // 4, args.steps[0]), (n // 2, args.steps[1]),
              (n, args.steps[2])]
    config = inverse.InverseConfig(
        resolution=res, spp=args.spp, learning_rate=args.lr, seed=17,
        two_level=True, tv_weight=args.tv, views_per_step=2,
    )

    def progress(lvl, step, loss):
        if step % 10 == 0:
            print(f"  {lvl} step {step:4d} loss {loss:.6f}", flush=True)

    t0 = time.time()
    density, losses = inverse.run_inverse_pyramid(
        targets, views, albedo, spec, settings, config, levels,
        init_value=0.25, progress=progress,
    )
    wall = time.time() - t0

    gt_np = np.asarray(gt)
    rec = np.asarray(density)
    mse0 = float(((0.25 - gt_np) ** 2).mean())
    mse1 = float(((rec - gt_np) ** 2).mean())
    split = inverse.split_mse_by_observability(
        rec, gt_np, 0.25, args.scale, tau_c=args.tau_c
    )
    tau = inverse.observability_depth(gt_np, args.scale)
    result = {
        "grid": f"{n}^3",
        "scale": args.scale,
        "views": args.views,
        "res": args.res,
        "spp": args.spp,
        "levels": [list(l) for l in levels],
        "wall_s": round(wall, 1),
        "loss_first": round(next(l[0] for l in losses if l), 6),
        "loss_last": round(
            next(l[-1] for l in reversed(losses) if l), 6),
        "grid_mse_ratio_overall": round(mse1 / mse0, 4),
        "center_tau_min": round(
            float(tau[n // 2, n // 2, n // 2]), 2),
        "observability_split": split,
    }
    print(json.dumps(result, indent=2), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
