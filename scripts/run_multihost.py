#!/usr/bin/env python
"""Multi-host sharded rendering / inverse-rendering entry point.

Launch one copy per host, each driving all of its host's GPUs (the
jax.distributed analog of the single-process reference, SURVEY.md §2.8):

    # host 0
    python scripts/run_multihost.py --coordinator 10.0.0.1:1234 \
        --num-processes 2 --process-id 0 scene.xml
    # host 1
    python scripts/run_multihost.py --coordinator 10.0.0.1:1234 \
        --num-processes 2 --process-id 1 scene.xml

Renders with samples sharded over all cards of all hosts (psum image
assembly over NVLink within a host and the network between hosts),
writes the image from process 0.  With
--inverse TARGET.hdr it instead runs the sharded inverse-rendering
optimization (per-voxel gradient all-reduce each step).
"""

import argparse
import sys


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("scene_file")
    parser.add_argument("--coordinator", required=False, default=None,
                        help="host:port of process 0 (omit for single host)")
    parser.add_argument("--num-processes", type=int, default=1)
    parser.add_argument("--process-id", type=int, default=0)
    parser.add_argument("-r", "--resolution", type=int, nargs="+",
                        default=[512, 512])
    parser.add_argument("-i", "--iterations", type=int, default=32)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("-o", "--output", default="multihost_render")
    parser.add_argument("--inverse", default=None,
                        help="target .hdr: run inverse recovery instead")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--platform", default=None,
                        help="force a jax platform (e.g. cpu; same as "
                        "JAX_PLATFORMS)")
    parser.add_argument("--host-devices", type=int, default=None,
                        help="virtual CPU devices per process "
                        "(xla_force_host_platform_device_count; for "
                        "multi-process smoke tests without a cluster)")
    args = parser.parse_args()

    if args.host_devices:
        import os

        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.host_devices}"
        )
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from cudavolumerenderer_tpu.utils.device import enable_compile_cache

    enable_compile_cache()
    if args.coordinator is not None:
        jax.distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
        )

    import numpy as np

    from cudavolumerenderer_tpu.config import Config
    from cudavolumerenderer_tpu.parallel.mesh import make_mesh
    from cudavolumerenderer_tpu.parallel.shard import render_sharded
    from cudavolumerenderer_tpu.scene.loader import load_scene
    from cudavolumerenderer_tpu.utils.image import save_hdr

    res = args.resolution
    if len(res) == 1:
        res = [res[0], res[0]]
    config = Config(
        scene_file=args.scene_file, resolution=(res[0], res[1]),
        iterations=args.iterations, seed=args.seed,
    )
    scene, camera = load_scene(config)
    mesh = make_mesh()
    n_dev = len(jax.devices())
    spp = max(args.iterations // n_dev, 1) * n_dev

    if args.inverse is None:
        img, n_rays = render_sharded(
            scene, camera, config.settings, (res[0], res[1]), spp,
            args.seed, mesh,
        )
        if jax.process_index() == 0:
            save_hdr(args.output + ".hdr", np.asarray(img) / spp)
            print(f"rendered {spp} spp on {n_dev} devices, "
                  f"{float(n_rays):.0f} rays -> {args.output}.hdr")
        return 0

    import jax.numpy as jnp
    import optax

    from cudavolumerenderer_tpu.models.differentiable import (
        CameraSpec, SceneSpec,
    )
    from cudavolumerenderer_tpu.parallel.shard import make_inverse_step
    from cudavolumerenderer_tpu.scene.types import RenderSettings
    from cudavolumerenderer_tpu.utils.image import load_hdr

    target = jnp.asarray(load_hdr(args.inverse))
    settings = RenderSettings.from_flags(
        True, russian_roulette=False, max_path_length=32, bsdf_kind="null"
    )
    spec = SceneSpec.from_scene(scene)
    import math

    fov = math.degrees(2 * math.atan(float(camera.raster_to_view[0])))
    cam_spec = CameraSpec(res_x=res[0], res_y=res[1], fov_x_deg=fov)
    optimizer = optax.adam(0.05)
    step = make_inverse_step(
        spec, cam_spec, settings, (res[0], res[1]),
        spp_per_device=max(spp // n_dev, 1), mesh=mesh,
        optimizer=optimizer,
    )
    density = jnp.asarray(scene.medium.density.data) * 0.5
    albedo = jnp.asarray(scene.medium.albedo.data)
    params = (density, albedo)
    opt_state = optimizer.init(params)
    for it in range(args.steps):
        params, opt_state, loss = step(params, opt_state, target,
                                       args.seed + it)
        if jax.process_index() == 0 and it % 10 == 0:
            print(f"step {it}: loss {float(loss):.6f}")
    if jax.process_index() == 0:
        np.savez(args.output + "_recovered.npz",
                 density=np.asarray(params[0]))
        print(f"wrote {args.output}_recovered.npz")
    return 0


if __name__ == "__main__":
    sys.exit(main())
