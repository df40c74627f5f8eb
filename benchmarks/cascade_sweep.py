#!/usr/bin/env python
"""Cascade bottom-width and tail-chaining sweep on the GPU.

For BASELINE configs 1 (bucky) and 2 (medical), loaded through their
file loaders, renders fastSK two-level at each cascade bottom width
(`min_width`) and tail chaining (`tail_chain`: body evaluations per
while-loop iteration, as a rolled loop, in pools at or below fast's
tail width) with `with_stats=True` and reports, per setting: wall time
per render through to the image on the host (median of --reps after a
compiling first call), compile seconds, Mrays/s, and each cascade
stage's width and body evaluations.  The tail pools are the stages
below full width; their evaluation count is what a per-iteration
launch cost multiplies.

    python benchmarks/cascade_sweep.py [--widths 256 1024 4096] \
        [--chains 1 8] [--reps 3]

Prints one JSON line per (config, width, chain).  Runs on the GPU only.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--widths", type=int, nargs="+",
                        default=[256, 1024, 4096])
    parser.add_argument("--chains", type=int, nargs="+", default=[8])
    parser.add_argument("--only", nargs="*", default=["bucky", "medical"])
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    from cudavolumerenderer_tpu.utils.device import (
        CompileStats,
        enable_compile_cache,
        require_gpu,
    )

    dev = require_gpu()
    enable_compile_cache()
    stats = CompileStats()

    from benchmarks.baseline_configs import CONFIGS, make_config
    from cudavolumerenderer_tpu.models import fast
    from cudavolumerenderer_tpu.scene.loader import load_scene

    tmp = tempfile.mkdtemp(prefix="cascade_sweep_")
    for name, writer, res, iters, tiles, _ in CONFIGS:
        if not any(s in name for s in args.only):
            continue
        config = make_config(writer(tmp), res, iters, tiles)
        scene, camera = load_scene(config)
        for width, chain in (
            (w, c) for w in args.widths for c in args.chains
        ):
            def render(seed):
                out = fast.render_tile(
                    scene, camera, config.settings, (res, res),
                    jnp.zeros(2, jnp.float32), (res, res), iters, seed, 0,
                    two_level=True, cascade_factor=config.cascade_factor,
                    min_width=width, tail_chain=chain, with_stats=True,
                )
                img = np.asarray(out[0])  # host readback ends the call
                return img, out

            c0 = stats.snapshot()[0]
            t0 = time.perf_counter()
            render(1)
            first_s = time.perf_counter() - t0
            compile_s = stats.snapshot()[0] - c0
            times = []
            for rep in range(args.reps):
                t0 = time.perf_counter()
                img, out = render(2 + rep)
                times.append(time.perf_counter() - t0)
            n_rays, n_rows, n_busy = (float(x) for x in out[1:4])
            widths = fast._cascade_widths(
                res * res, config.cascade_factor, width
            )
            stage_evals = [
                float(r) / w for w, r in zip(widths, np.asarray(out[4]))
            ]
            wall = float(np.median(times))
            print(json.dumps({
                "config": name, "min_width": width, "tail_chain": chain,
                "render_s": wall, "reps_s": times,
                "mrays_per_s": n_rays / wall / 1e6,
                "first_call_s": first_s, "compile_s": compile_s,
                "n_rays": n_rays, "busy_share": n_busy / n_rows,
                "stages": [
                    {"width": w, "body_evals": n}
                    for w, n in zip(widths, stage_evals)
                ],
                "tail_body_evals": sum(stage_evals[1:]),
                "image_mean": float(img.mean()),
                "device": dev.device_kind,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
