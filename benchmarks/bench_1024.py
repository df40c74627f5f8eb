#!/usr/bin/env python
"""BASELINE north-star config: 1024^3 sparse (VDB-class) volume at
1024x1024 with the flagship wavefront scheduler.

The reference's hetvol class is a sparse smoke volume; here the grid is
generated on the device (a 4.3 GB density never crosses PCIe): a plume
with hard zeros outside (~17% occupancy), constant albedo (the fused
table stays density-only so the whole scene fits device memory), scale
100.  Runs on the GPU only.

Reports forward Mrays/s; with --bwd also times render_diff's
forward+backward on a reduced pixel budget (the gradient replay is a
separate estimator; see models/differentiable.py).
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def make_density_1024(n: int = 1024):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def build():
        z = jnp.linspace(0.0, 1.0, n).reshape(-1, 1, 1)
        y = jnp.linspace(0.0, 1.0, n).reshape(1, -1, 1)
        x = jnp.linspace(0.0, 1.0, n).reshape(1, 1, -1)
        r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2
        base = jnp.exp(-r2 / (0.02 + 0.12 * z)) * (1.0 - 0.55 * z)
        # cheap deterministic 3D hash noise (no host RNG upload)
        zi = (z * (n - 1)).astype(jnp.uint32)
        yi = (y * (n - 1)).astype(jnp.uint32)
        xi = (x * (n - 1)).astype(jnp.uint32)
        h = (
            (zi // 64) * jnp.uint32(0x9E3779B9)
            ^ (yi // 64) * jnp.uint32(0x85EBCA6B)
            ^ (xi // 64) * jnp.uint32(0xC2B2AE35)
        )
        h = h ^ (h >> 15)
        h = h * jnp.uint32(0x2C1B3C6D)
        h = h ^ (h >> 12)
        noise = (h >> 8).astype(jnp.float32) * (1.0 / (1 << 24))
        d = base * (0.55 + 0.45 * noise) - 0.25
        return jnp.maximum(d, 0.0).astype(jnp.float32)

    return build()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n", type=int, default=1024)
    parser.add_argument("--res", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=4)
    parser.add_argument("--bwd", action="store_true")
    parser.add_argument(
        "--bwd-res", type=int, default=None,
        help="pixel width for the fwd+bwd measurement (default res//4)")
    parser.add_argument("--bwd-spp", type=int, default=1)
    parser.add_argument("--no-fwd", action="store_true",
                        help="skip the forward block (bwd-only runs)")
    parser.add_argument(
        "--brick-major", action="store_true",
        help="8^3 brick-major flat-table layout (texture-locality analog)",
    )
    parser.add_argument("--defer-ggx", type=int, default=0)
    parser.add_argument("--min-width", type=int, default=None)
    parser.add_argument("--table-bits", type=int, default=32,
                        choices=[32, 8, 4],
                        help="quantized packed density table: 4.3 GB "
                        "f32 -> 1.07 GB (8) / 537 MB (4); routed "
                        "through Config.effective_table_bits with the "
                        "explicit opt-in (reduced precision)")
    parser.add_argument(
        "--max-bricks", type=int, default=None,
        help="majorant-grid granularity cap (fast.pick_brick budget): "
        "the 1024^3 majorant-quality sweep knob")
    parser.add_argument(
        "--brick-size", type=int, nargs=3, default=None,
        help="explicit (bz by bx) brick size override")
    parser.add_argument("--cascade-factor", type=float, default=2)
    parser.add_argument(
        "--bwd-no-cascade", action="store_true",
        help="A/B: run the backward with the single-pool fused replay "
        "(pre-round-5) instead of the cascaded one")
    args = parser.parse_args()

    from cudavolumerenderer_tpu.utils.device import (
        enable_compile_cache,
        require_gpu,
    )

    require_gpu()
    enable_compile_cache()
    import jax.numpy as jnp

    from cudavolumerenderer_tpu.models import fast
    from cudavolumerenderer_tpu.ops.camera import make_camera
    from cudavolumerenderer_tpu.scene.types import (
        RenderSettings,
        make_medium,
        make_scene,
    )

    density = make_density_1024(args.n)
    occ = float((density > 0).mean())
    dmax = float(density.max())
    print(f"grid {args.n}^3  occupancy={occ*100:.1f}%  max={dmax:.3f}",
          flush=True)

    scene = make_scene(
        make_medium(density, (0.9, 0.9, 0.9), scale=100.0,
                    max_density=dmax)
    )
    res = args.res
    camera = make_camera(res, res)
    settings = RenderSettings.from_flags(True)
    from cudavolumerenderer_tpu.config import Config

    eff_bits = Config(
        table_bits=args.table_bits, allow_quantized=True,
        settings=settings,
    ).effective_table_bits
    kw = dict(
        scene=scene, camera=camera, settings=settings,
        tile_dim=(res, res), tile_offset=jnp.zeros(2, jnp.float32),
        full_resolution=(res, res), spp=args.iters,
        two_level=True, with_stats=True,
        brick_major=args.brick_major, defer_ggx=args.defer_ggx,
        table_bits=eff_bits, min_width=args.min_width,
        cascade_factor=args.cascade_factor,
    )
    if args.max_bricks is not None:
        kw["max_bricks"] = args.max_bricks
    if args.brick_size is not None:
        kw["brick_size"] = tuple(args.brick_size)
    if not args.no_fwd:
        out = fast.render_tile(seed=1, path_id_base=0, **kw)
        _ = float(out[0].sum())  # host readback: waits for the device
        n_rays, n_rows, n_busy = (
            float(out[1]), float(out[2]), float(out[3])
        )
        stage_rows = [float(x) for x in out[4]]
        widths = fast._cascade_widths(
            res * res, args.cascade_factor,
            args.min_width or fast._default_min_width(),
        )
        print(
            f"stats: rays={n_rays:.0f} rows={n_rows:.0f} "
            f"busy={n_busy / max(n_rows, 1):.3f} "
            f"width_equiv={n_rows / (res * res):.0f}",
            flush=True,
        )
        for w, r in zip(widths, stage_rows):
            print(f"  stage w={w:8d}: iters={r / w:7.0f} "
                  f"width_equiv={r / (res * res):6.1f}", flush=True)
        best = None
        for s in (7, 8):
            t0 = time.perf_counter()
            out = fast.render_tile(seed=s, path_id_base=0, **kw)
            _ = float(out[0].sum())
            dt = time.perf_counter() - t0
            mrays = float(out[1]) / dt / 1e6
            print(f"fwd seed={s}: {dt:.3f}s  {mrays:.2f} Mrays/s",
                  flush=True)
            best = max(best or 0.0, mrays)
        print(f"BEST fwd: {best:.2f} Mrays/s ({args.n}^3, {res}^2, "
              f"{args.iters} it)", flush=True)

    if args.bwd:
        # fwd+bwd: gradient of a scalar loss w.r.t. the 1024^3 density
        # through the two-level differentiable estimator (path-replay
        # backprop; d_density is a second 4.3 GB grid).
        import jax

        from cudavolumerenderer_tpu.models import differentiable
        from cudavolumerenderer_tpu.models.differentiable import (
            CameraSpec,
            SceneSpec,
            render_diff,
        )

        if args.bwd_no_cascade:
            differentiable.REPLAY_CASCADE = False
            print("bwd: cascade DISABLED (single-pool fused replay)",
                  flush=True)
        if args.max_bricks is not None:
            differentiable.DIFF_MAX_BRICKS = args.max_bricks
            print(f"bwd: DIFF_MAX_BRICKS={args.max_bricks}", flush=True)
        if args.cascade_factor != 2:
            differentiable.DIFF_CASCADE_FACTOR = args.cascade_factor
            print(f"bwd: DIFF_CASCADE_FACTOR={args.cascade_factor}",
                  flush=True)

        bres = args.bwd_res or args.res // 4
        bspp = args.bwd_spp
        spec = SceneSpec(scale=100.0, max_density=dmax)
        cam = CameraSpec(res_x=bres, res_y=bres, fov_x_deg=0.7)
        dsettings = RenderSettings.from_flags(
            True, russian_roulette=True, max_path_length=100
        )
        albedo_grid = jnp.full((1, 1, 1, 4), 0.9, jnp.float32)

        # Ray count for the fwd+bwd workload: the replay re-traces the
        # same two-level estimator family, so the forward fast path's
        # bounce counter at the same (res, spp, settings) is the number
        # of physical ray segments in the estimate (each is then
        # traversed 3x: primal + pass A + pass B).
        cimg, cnr = fast.render_tile(
            scene, camera, dsettings, (bres, bres),
            jnp.zeros(2, jnp.float32), (bres, bres), bspp, 4, 0,
            two_level=True,
        )
        _ = float(cimg.sum())
        n_rays_bwd = float(cnr)
        n_paths = bres * bres * bspp
        print(f"bwd workload: {bres}^2 x {bspp} spp = {n_paths} paths, "
              f"~{n_rays_bwd:.0f} rays/estimate "
              f"({n_rays_bwd / n_paths:.1f} bounces/path)", flush=True)

        # anatomy: one replay's worth (the primal) alone
        prim = jax.jit(
            lambda dg, s: render_diff(
                dg, albedo_grid, s, spec, cam, dsettings,
                (bres, bres), bspp, True,
            )
        )
        _ = float(prim(density, 2).sum())
        t0 = time.perf_counter()
        _ = float(prim(density, 3).sum())
        t_prim = time.perf_counter() - t0
        print(f"primal replay alone: {t_prim:.3f}s "
              f"({n_rays_bwd / t_prim / 1e6:.2f} Mrays/s)", flush=True)

        def loss(dgrid, seed):
            img = render_diff(
                dgrid, albedo_grid, seed, spec, cam, dsettings,
                (bres, bres), bspp, True,
            )
            return jnp.mean(img)

        # donate the grid: four whole-grid buffers (input, flat copy,
        # cotangent, grad out) of 4.3 GB each; the grid is deterministic
        # and cheap to regenerate per rep
        vg = jax.jit(jax.value_and_grad(loss), donate_argnums=(0,))
        val, g = vg(density, 3)
        _ = float(val), float(g.sum())  # sync
        del g
        for s in (4, 5):
            dgrid = make_density_1024(args.n)
            t0 = time.perf_counter()
            val, g = vg(dgrid, s)
            gs = float(g.sum())
            dt = time.perf_counter() - t0
            del g
            print(
                f"fwd+bwd seed={s}: {dt:.3f}s  "
                f"{n_paths/dt/1e6:.3f} Mpaths/s  "
                f"{n_rays_bwd/dt/1e6:.2f} Mrays/s (effective)  "
                f"{3*n_rays_bwd/dt/1e6:.2f} Mrays/s (traced)  "
                f"loss={float(val):.4f} gsum={gs:.3e}",
                flush=True,
            )
            print(
                f"  anatomy: primal {t_prim:.3f}s x3 passes "
                f"~{3*t_prim:.3f}s vs total {dt:.3f}s -> "
                f"adjoint-scatter overhead ~{dt - 3*t_prim:.3f}s",
                flush=True,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
