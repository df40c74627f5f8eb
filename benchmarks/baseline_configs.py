#!/usr/bin/env python
"""BASELINE.json forward configs 1-4, end to end through the real file
loaders and the CLI's run_test protocol (trials, discard-first mean,
Mrays/s — Main.cpp:46-121 semantics), on the GPU.

Each config builds its scene FILE from a seed in a temporary directory
first (the reference assets are LFS-stubbed), then loads it through the
same path a user would:

  1. bucky: 32^3 raw uchar file -> RawSceneBuilder semantics, 256^2x20.
  2. medical: 256^3 MHD file (smoothstep CT convention) at 512^2 —
     the manix/artifix class.
  3. hetvol: smoke 128x128x50 written to a real .vdb archive (native
     writer), loaded by the native reader, 1024^2 — the VDB wavefront
     config.
  4. MitsubaXml: density+albedo .vol files + scene XML, 10x10 tiled
     progressive, 50 iterations.

Prints the results as JSON (and writes them to --out if given).

    python benchmarks/baseline_configs.py [--only bucky] [--trials 3]
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, ".")


def write_bucky(tmp):
    from cudavolumerenderer_tpu.scene import procedural

    path = os.path.join(tmp, "bucky_synth.raw")
    procedural.write_raw_uchar(path, procedural.blob_volume((32, 32, 32)))
    return path


def write_medical_mhd(tmp):
    from cudavolumerenderer_tpu.scene import procedural

    n = 256
    d = procedural.medical_volume((n, n, n), n_blobs=40)
    # write CT-style counts; the loader min-max normalizes and applies
    # smoothstep(0.2, 0.6) — the manix/artifix pipeline convention
    # (scripts/convert-mhd/mhd_to_vdb.py)
    raw = d * 4095.0
    raw_path = os.path.join(tmp, "medical_synth.raw")
    raw.astype("<u2").tofile(raw_path)
    mhd_path = os.path.join(tmp, "medical_synth.mhd")
    with open(mhd_path, "w") as f:
        f.write(
            "ObjectType = Image\nNDims = 3\nBinaryData = True\n"
            "BinaryDataByteOrderMSB = False\n"
            f"DimSize = {n} {n} {n}\n"
            "ElementType = MET_USHORT\n"
            "ElementSpacing = 1 1 1\n"
            f"ElementDataFile = {os.path.basename(raw_path)}\n"
        )
    return mhd_path


def write_hetvol_vdb(tmp):
    from cudavolumerenderer_tpu.scene import procedural, vdb

    d = procedural.smoke_volume((128, 128, 50))
    alb = np.stack([d, d, d], axis=-1) * 0.9
    path = os.path.join(tmp, "hetvol_synth.vdb")
    vdb.write_vdb(path, d.astype(np.float32), alb.astype(np.float32))
    return path


def write_mitsuba_xml(tmp):
    from cudavolumerenderer_tpu.scene import procedural
    from cudavolumerenderer_tpu.scene.vol import write_vol

    d = procedural.smoke_volume((128, 128, 50)).astype(np.float32)
    alb = (np.stack([d, d, d], axis=-1) * 0.9).astype(np.float32)
    box_min, box_max = (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)
    write_vol(os.path.join(tmp, "density.vol"), d, box_min, box_max)
    write_vol(os.path.join(tmp, "albedo.vol"), alb, box_min, box_max)
    xml = """<scene version="0.5.0">
  <medium type="heterogeneous" id="smoke">
    <volume name="density" type="gridvolume">
      <string name="filename" value="density.vol"/>
    </volume>
    <volume name="albedo" type="gridvolume">
      <string name="filename" value="albedo.vol"/>
    </volume>
    <float name="scale" value="100"/>
  </medium>
  <sensor type="perspective">
    <!-- frame the unit box from z=100 (it subtends ~0.57 deg): at
         fov=45 99.98% of pixels are empty sky -->
    <float name="fov" value="0.7"/>
    <film type="hdrfilm">
      <integer name="width" value="400"/>
      <integer name="height" value="400"/>
    </film>
  </sensor>
</scene>
"""
    path = os.path.join(tmp, "hetvol_scene.xml")
    with open(path, "w") as f:
        f.write(xml)
    return path


#: BASELINE.json forward configs 1-4 at their published sizes:
#: (name, scene-file writer, resolution, iterations, tiles, reference row)
CONFIGS = (
    ("1_bucky_raw_256_20it", write_bucky, 256, 20, (1, 1),
     "thesis T6.3 regenSK 10.96 Mrays/s"),
    ("2_medical_mhd_512", write_medical_mhd, 512, 4, (1, 1),
     "thesis T4.3 manix regenSK 11.4-14.8 Mrays/s"),
    ("3_hetvol_vdb_1024", write_hetvol_vdb, 1024, 4, (1, 1),
     "thesis T6.2 streamingSK 17.41 Mrays/s (400^2)"),
    ("4_mitsubaxml_10x10_50it", write_mitsuba_xml, 400, 50, (10, 10),
     "config 4: tiled progressive, 10x10 tiles"),
)


def make_config(scene_file, res, iters, tiles, **kw):
    """The render Config every forward cell uses: fastSK, two-level
    tracking, f32 tables, default knobs."""
    from cudavolumerenderer_tpu.config import Config, Kernel
    from cudavolumerenderer_tpu.scene.types import RenderSettings

    return Config(
        scene_file=scene_file, kernel=Kernel.FAST_SK, iterations=iters,
        resolution=(res, res), n_tiles=tiles, two_level=True,
        settings=RenderSettings.from_flags(True), **kw,
    )


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--trials", type=int, default=3)
    parser.add_argument("--quick", action="store_true",
                        help="64^2 resolutions and at most 5 iterations")
    parser.add_argument("--out", default=None,
                        help="also write the results JSON here")
    parser.add_argument(
        "--only", nargs="*", default=None,
        help="run only configs whose name contains any substring")
    args = parser.parse_args()

    import jax

    from cudavolumerenderer_tpu.utils.device import (
        enable_compile_cache,
        require_gpu,
    )

    require_gpu()
    enable_compile_cache()
    from cudavolumerenderer_tpu import cli

    tmp = tempfile.mkdtemp(prefix="baseline_cfg_")
    rows = [
        r for r in CONFIGS
        if not args.only or any(s_ in r[0] for s_ in args.only)
    ]
    results = {}
    for name, writer, res, iters, tiles, ref in rows:
        if args.quick:
            res, iters = 64, min(iters, 5)
        path = writer(tmp)
        config = make_config(
            path, res, iters, tiles, trials=args.trials,
            output_name=os.path.join(tmp, name),
        )
        print(f"=== {name} ({path})", flush=True)
        r = cli.run_test(config)
        results[name] = {
            "mrays_per_sec": r["mrays_per_sec"],
            "mean_time_s": r["mean_time"],
            "resolution": res, "iterations": iters,
            "tiles": list(tiles), "reference": ref,
            "device": jax.devices()[0].device_kind,
        }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
