"""CLI end-to-end tests: flag parsing parity with the reference and a
tiny batch render through the real entry point."""

import os

import numpy as np
import pytest

from cudavolumerenderer_tpu import cli
from cudavolumerenderer_tpu.config import Kernel, SceneType
from cudavolumerenderer_tpu.scene.procedural import blob_volume, write_raw_uchar
from cudavolumerenderer_tpu.utils.image import load_hdr


class TestParsing:
    def test_defaults_match_reference(self):
        args = cli.build_parser().parse_args(["scene.xml"])
        config = cli.config_from_args(args)
        # the reference defaults to its fastest scheduler
        # (regenerationSK); ours is fastSK
        assert config.kernel == Kernel.FAST_SK
        assert config.iterations == 20
        assert config.resolution == (1024, 1024)
        assert config.n_tiles == (1, 1)
        assert config.trials == 1
        assert config.output_name == (
            "algorithm_cudaVolPath_kernel_fastSK_iter_20"
        )

    def test_single_value_broadcast(self):
        """-r 512 means 512x512; --number-of-tiles 4 means 4x4
        (reference: ConfigParser.cpp:129-134)."""
        args = cli.build_parser().parse_args(
            ["s.raw", "-r", "512", "--number-of-tiles", "4"]
        )
        config = cli.config_from_args(args)
        assert config.resolution == (512, 512)
        assert config.n_tiles == (4, 4)

    def test_scene_type_autodetect(self):
        assert SceneType.detect("x.xml") == SceneType.MITSUBA_XML
        assert SceneType.detect("x.vdb") == SceneType.VDB
        assert SceneType.detect("x.mhd") == SceneType.MHD
        assert SceneType.detect("x.npz") == SceneType.NPZ
        assert SceneType.detect("Bucky.raw") == SceneType.RAW
        assert SceneType.detect("noext") == SceneType.RAW

    def test_unknown_kernel_message(self):
        with pytest.raises(ValueError, match="naiveSK"):
            Kernel.from_name("bogus")

    def test_quantized_table_gate(self):
        """table_bits < 32 under mitsuba_comparable needs the explicit
        --allow-quantized opt-in; the opt-in keeps trilinear filtering
        (quantized champions must be CLI-reachable through the
        production gate)."""
        args = cli.build_parser().parse_args(["s.raw", "--table-bits", "4"])
        config = cli.config_from_args(args)
        assert config.effective_table_bits == 32

        args = cli.build_parser().parse_args(
            ["s.raw", "--table-bits", "4", "--allow-quantized"]
        )
        config = cli.config_from_args(args)
        assert config.effective_table_bits == 4
        # comparability conventions stay: trilinear, not nearest
        assert config.settings.mitsuba_comparable
        assert config.settings.interpolation == "trilinear"

        # non-comparable mode never needed the opt-in
        args = cli.build_parser().parse_args(
            ["s.raw", "--table-bits", "8",
             "--mitsuba-comparable", "false"]
        )
        config = cli.config_from_args(args)
        assert config.effective_table_bits == 8


class TestEndToEnd:
    def test_batch_render_writes_outputs(self, tmp_path):
        raw = str(tmp_path / "scene.raw")
        write_raw_uchar(raw, blob_volume())
        out = str(tmp_path / "result")
        rc = cli.main(
            [
                raw, "-k", "fastSK", "-i", "2", "-r", "16", "16",
                "-o", out, "--trials", "1",
            ]
        )
        assert rc == 0
        img = load_hdr(out + ".hdr")
        assert img.shape == (16, 16, 3)
        assert np.isfinite(img).all() and img.max() > 0
        assert os.path.exists(out + ".png")

    def test_interactive_mode_dumps_frames(self, tmp_path):
        raw = str(tmp_path / "scene.raw")
        write_raw_uchar(raw, blob_volume())
        out = str(tmp_path / "prog")
        rc = cli.main(
            [
                raw, "-k", "fastSK", "-i", "2", "-r", "8", "8",
                "-o", out, "--interactive", "true",
            ]
        )
        assert rc == 0
        assert os.path.exists(out + "_frame0001.png")
        assert os.path.exists(out + ".hdr")
