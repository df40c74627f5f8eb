#!/usr/bin/env python
"""BASELINE config 5: recover a 256^3 density grid from target renders.

Round-2 recipe (the round-1 single-view Adam run *diverged*,
grid_mse_ratio 1.27):

  * multi-view orbit targets (depth ambiguity broken; a single view
    cannot constrain density along rays — models/inverse.py);
  * Russian roulette OFF (the replay detaches RR decisions, so RR-on
    gradients are biased);
  * albedo 0.6: absorption contrast couples the image strongly to
    optical depth AND bounds the REINFORCE score variance (path
    contribution decays 0.6^n, so deep-path score noise is damped);
  * coarse-to-fine pyramid 64^3 -> 128^3 -> 256^3 with trilinear
    upsampling: coarse voxels pool many paths (well-conditioned), fine
    levels only refine;
  * total-variation prior (the medical-class field is smooth);
  * view minibatching through ONE compiled step (traced camera).

Multi-card: the same step runs sharded via parallel/shard.make_inverse_step
(two_level supported); this driver runs on one card and the sharded
path is exercised by `chip_smoke.py --four`,
__graft_entry__.dryrun_multichip and tests/test_sharding.py.

Reports: per-level loss trajectory, relative grid MSE (init -> final),
wall time.  Done-criterion: grid_mse_ratio <= 0.5 at 256^3.
"""

import argparse
import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=256)
    parser.add_argument("--res", type=int, default=128)
    parser.add_argument("--views", type=int, default=8)
    parser.add_argument("--spp", type=int, default=8)
    parser.add_argument("--target-spp", type=int, default=64)
    parser.add_argument("--lr", type=float, default=0.05)
    parser.add_argument(
        "--scale", type=float, default=12.0,
        help="sigma_t multiplier; chosen so the phantom's center-line "
        "optical depth is ~7 (observable interior).  The round-1 run "
        "used 100 (optical depth ~57): interior voxels were pitch "
        "black, fundamentally unrecoverable, and the fit diverged.",
    )
    parser.add_argument("--tv", type=float, default=2e-3)
    parser.add_argument(
        "--spp-chunks", type=int, default=2,
        help="split each view's grad into this many device programs "
        "(bounds per-program duration and memory)",
    )
    parser.add_argument(
        "--steps", type=int, nargs="+", default=[80, 60, 40],
        help="steps per pyramid level",
    )
    parser.add_argument("--out", default=None,
                        help="also write the result JSON here")
    parser.add_argument(
        "--ckpt-dir", default=".inv256_ckpt",
        help="checkpoint directory (per-level subdirs)",
    )
    parser.add_argument(
        "--resume", action="store_true",
        help="resume from the deepest checkpoint in --ckpt-dir (exact "
        "replay: Adam moments + seed schedule are restored); targets "
        "are re-used from the cache written on the first run",
    )
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

    import os

    os.makedirs(args.ckpt_dir, exist_ok=True)
    tgt_cache = os.path.join(
        args.ckpt_dir,
        f"targets_n{n}_v{args.views}_r{args.res}_s{args.target_spp}"
        f"_sc{args.scale:g}.npz",
    )
    t0 = time.time()
    if args.resume and os.path.exists(tgt_cache):
        targets = jnp.asarray(np.load(tgt_cache)["targets"])
        t_targets = 0.0
        print(f"targets: loaded cache {tgt_cache}", flush=True)
    else:
        targets = inverse.render_view_targets(
            gt, albedo, spec, views, settings, res, args.target_spp, True
        )
        targets.block_until_ready()
        t_targets = time.time() - t0
        np.savez(tgt_cache, targets=np.asarray(targets))
        print(f"targets: {args.views} views x {args.target_spp} spp, "
              f"{t_targets:.1f}s", flush=True)

    levels = []
    sizes = [n // 4, n // 2, n]
    for size, steps in zip(sizes, args.steps):
        levels.append((size, steps))

    config = inverse.InverseConfig(
        resolution=res, spp=args.spp, learning_rate=args.lr, seed=17,
        two_level=True, tv_weight=args.tv, views_per_step=2,
        spp_chunks=args.spp_chunks,
        checkpoint_dir=args.ckpt_dir, checkpoint_every=10,
    )

    def progress(lvl, step, loss):
        if step % 10 == 0:
            print(f"  {lvl} step {step:4d} loss {loss:.6f}", flush=True)

    t0 = time.time()
    density, losses = inverse.run_inverse_pyramid(
        targets, views, albedo, spec, settings, config, levels,
        init_value=0.25, progress=progress, resume=args.resume,
    )
    wall = time.time() - t0

    gt_np = np.asarray(gt)
    mse0 = float(((0.25 - gt_np) ** 2).mean())
    mse1 = float(((np.asarray(density) - gt_np) ** 2).mean())
    result = {
        "grid": f"{n}^3",
        "scale": args.scale,
        "views": args.views,
        "res": args.res,
        "spp": args.spp,
        "levels": [list(l) for l in levels],
        "tv_weight": args.tv,
        "wall_s": round(wall, 1),
        "target_render_s": round(t_targets, 1),
        "loss_first": round(
            next(l[0] for l in losses if l), 6
        ),
        "loss_last": round(
            next(l[-1] for l in reversed(losses) if l), 6
        ),
        "grid_mse_init": round(mse0, 6),
        "grid_mse_final": round(mse1, 6),
        "grid_mse_ratio": round(mse1 / mse0, 4),
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
