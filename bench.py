#!/usr/bin/env python
"""Forward-render benchmark on the GPU: BASELINE config 1.

Bucky-class 32^3 raw grid (written from a seed, loaded through the raw
loader), 256x256, 20 iterations, fastSK two-level with default knobs —
the same Config as chip_smoke.py's first forward cell, so a run after
chip_smoke.py in one session finds its program in the compile cache.
Each trial times render() through to the image on the host.  Reference:
the reference's best bucky number, regenerationSK (thread) at 10.96
Mrays/s on the GT 650M (BASELINE.md, thesis Table 6.3).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", ...}.  Exits non-zero without a GPU.
"""

import json
import sys
import tempfile
import time


def main() -> int:
    import jax

    from cudavolumerenderer_tpu.utils.device import (
        CompileStats,
        enable_compile_cache,
        gpu_name_and_power_limit,
        require_gpu,
    )

    dev = require_gpu()
    enable_compile_cache()
    stats = CompileStats()

    from benchmarks.baseline_configs import make_config, write_bucky
    from cudavolumerenderer_tpu.models.renderer import create_renderer
    from cudavolumerenderer_tpu.scene.loader import load_scene

    with tempfile.TemporaryDirectory(prefix="bench_") as tmp:
        config = make_config(write_bucky(tmp), 256, 20, (1, 1))
        scene, camera = load_scene(config)
    renderer = create_renderer(scene, camera, config)

    t0 = time.perf_counter()
    renderer.render()  # compiles, or loads from the compile cache
    first_s = time.perf_counter() - t0
    compile_s, hits, _ = stats.snapshot()

    # Reference protocol (Main.cpp:100-119): N trials, discard the
    # first, report the mean.  Fresh seed per trial.
    trials = []
    for _ in range(4):
        config.seed += 1
        t0 = time.perf_counter()
        renderer.render()
        elapsed = time.perf_counter() - t0
        trials.append(renderer.n_rays / (elapsed * 1e6))
    mrays = sum(trials[1:]) / len(trials[1:])

    baseline_mrays = 10.96  # reference regenerationSK(thread), bucky 32^3
    print(
        json.dumps(
            {
                "metric": (
                    "Mrays/s bucky32 256px 20it, fastSK two-level default "
                    "knobs, render() incl. image download"
                ),
                "timing": "mean of trials 2-4 of 4; each trial is one "
                "render() call through to the image on the host",
                "value": mrays,
                "unit": "Mrays/s",
                "vs_baseline": mrays / baseline_mrays,
                "trials_mrays": trials,
                "first_call_s": first_s,
                "compile_s": compile_s,
                "compile_cache_hits": hits,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "card": gpu_name_and_power_limit(),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
