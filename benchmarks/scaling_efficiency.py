"""Scaling-efficiency harness: rays/s at mesh sizes 1..N GPUs + psum cost.

BASELINE.md sets a >=85% rays/s scaling-efficiency target.  This harness
measures it on the GPUs the process sees (one process drives all cards
of a host; rows cover 1, 2, 4, ... cards).

Method: weak scaling (spp_per_device held constant, total spp =
N * spp_per_device), kernel = fastSK two-level via render_sharded;
per-rep host-readback fences; rep 0 discarded.
efficiency(N) = rays_per_sec(N) / (N * rays_per_sec(1)).

Usage:
  python benchmarks/scaling_efficiency.py [--compare-plain]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp-per-device", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json-out", default=None)
    ap.add_argument(
        "--compare-plain", action="store_true",
        help="also measure the UNSHARDED fast.render_tile dispatch at "
        "the same total spp on this process's first device: the "
        "sharded-dispatch overhead (mesh + shard_map + psum machinery "
        "at N=1) should stay <5%%")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from cudavolumerenderer_tpu.utils.device import (
        enable_compile_cache,
        require_gpu,
    )

    require_gpu()
    enable_compile_cache()
    import numpy as np

    from cudavolumerenderer_tpu.ops.camera import make_camera
    from cudavolumerenderer_tpu.parallel.mesh import make_mesh
    from cudavolumerenderer_tpu.parallel.shard import render_sharded
    from cudavolumerenderer_tpu.scene import procedural
    from cudavolumerenderer_tpu.scene.types import (
        RenderSettings, make_medium, make_scene,
    )

    res = args.res
    dens = procedural.blob_volume((32, 32, 32), n_blobs=5)
    albedo = np.stack(
        [dens, 0.5 * np.ones_like(dens), 1.0 - dens], axis=-1
    )
    scene = make_scene(make_medium(dens, albedo, scale=40.0,
                                   max_density=1.0))
    camera = make_camera(res, res)
    settings = RenderSettings.from_flags(True, russian_roulette=False)
    n_total = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_total]
    rows = []

    def make_run(mesh, spp):
        """One jitted closure per mesh size, seed TRACED: render_sharded
        constructs a fresh shard_map per call, so calling it eagerly
        re-traces every rep.  Under jit the shard_map is traced once
        and reps hit the executable cache."""

        @jax.jit
        def fn(seed):
            return render_sharded(
                scene, camera, settings, (res, res), spp, seed, mesh,
                kernel="fast", two_level=True,
            )

        def run(seed):
            img, n_rays = fn(jnp.uint32(seed))
            return float(jnp.asarray(img).sum()), float(n_rays)

        return run

    for n in sizes:
        mesh = make_mesh(n)
        spp = args.spp_per_device * n
        run = make_run(mesh, spp)
        times, rays = [], 0.0
        for rep in range(args.reps + 1):
            t0 = time.time()
            _, nr = run(seed=1000 + rep)
            dt = time.time() - t0
            if rep:
                times.append(dt)
            rays = nr
            print(f"  N={n} rep{rep}: {dt*1e3:.1f} ms ({nr:.0f} rays)")
        best = min(times)
        rows.append({"n": n, "spp": spp, "s": best,
                     "rays_per_s": rays / best})
    base = rows[0]["rays_per_s"]
    for r in rows:
        r["efficiency"] = r["rays_per_s"] / (r["n"] * base)
        print(f"N={r['n']:2d}: {r['rays_per_s']/1e6:7.2f} Mrays/s  "
              f"efficiency {r['efficiency']*100:5.1f}%")

    plain_row = None
    if args.compare_plain:
        from cudavolumerenderer_tpu.models import fast

        spp = args.spp_per_device  # N=1 workload
        times = []
        for rep in range(args.reps + 1):
            t0 = time.time()
            img, nr = fast.render_tile(
                scene, camera, settings, (res, res),
                jnp.zeros(2, jnp.float32), (res, res), spp,
                1000 + rep, 0, two_level=True,
            )
            _ = float(jnp.asarray(img).sum())
            dt = time.time() - t0
            if rep:
                times.append(dt)
        plain_s = min(times)
        sharded_s = rows[0]["s"]
        overhead = sharded_s / plain_s - 1.0
        plain_row = {
            "plain_s": plain_s, "sharded_n1_s": sharded_s,
            "sharded_dispatch_overhead": overhead,
        }
        print(f"plain dispatch: {plain_s*1e3:.1f} ms vs sharded N=1 "
              f"{sharded_s*1e3:.1f} ms -> overhead "
              f"{overhead*100:+.1f}% (target <5%)")

    dev = jax.devices()[0]
    out = {"platform": dev.platform, "device_kind": dev.device_kind,
           "n_devices": n_total, "res": res,
           "spp_per_device": args.spp_per_device,
           "rows": rows, "plain_comparison": plain_row}
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.json_out)


if __name__ == "__main__":
    main()
