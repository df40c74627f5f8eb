"""Native library (csrc/cvr_native.cpp) vs NumPy-fallback agreement."""

import numpy as np
import pytest

from cudavolumerenderer_tpu.utils import native


def fresh():
    native._TRIED = False
    native._LIB = None


def test_failed_build_raises_naming_command(tmp_path, monkeypatch):
    """The .vdb reader has no fallback: a library that cannot be built
    is an error that names the build command, not a silent skip."""
    fresh()
    monkeypatch.setattr(native, "_repo_root", lambda: str(tmp_path))
    try:
        assert not native.available()
        with pytest.raises(RuntimeError, match="make -s -C"):
            native.vdb_grid_info(str(tmp_path / "x.vdb"), "density")
    finally:
        monkeypatch.undo()
        fresh()


class TestNative:
    def test_builds_and_loads(self):
        fresh()
        assert native.available(), "native lib should build with make"

    def test_morton_known_codes(self):
        fresh()
        v = np.random.RandomState(0).rand(8, 8, 8).astype(np.float32)
        m = native.morton_reorder(v)
        # interleave x*4 + y*2 + z: voxel (x,y,z)=(1,0,0) -> code 4
        assert m[4] == v[0, 0, 1]
        assert m[2] == v[0, 1, 0]
        assert m[1] == v[1, 0, 0]
        assert m[7] == v[1, 1, 1]

    def test_brick_pack_matches_fallback(self):
        fresh()
        v = np.random.RandomState(1).rand(10, 9, 17).astype(np.float32)
        nb, bm, dims = native.brick_pack(v)
        native._LIB = None
        fb, fm, fdims = native.brick_pack(v)
        np.testing.assert_array_equal(nb, fb)
        np.testing.assert_allclose(bm, fm)
        assert dims == fdims == (3, 3, 3)

    def test_brick_max_is_majorant(self):
        fresh()
        v = np.random.RandomState(2).rand(8, 8, 16).astype(np.float32)
        bm = native.brick_max(v)
        assert bm.shape == (2, 2, 2)
        np.testing.assert_allclose(bm[0, 0, 0], v[:4, :4, :8].max())
        assert bm.max() <= v.max() + 1e-7

    def test_rgbe_roundtrip(self):
        fresh()
        from cudavolumerenderer_tpu.utils.image import _rgbe_decode

        rgb = np.random.RandomState(3).rand(64, 3).astype(np.float32) * 4
        e = native.rgbe_encode(rgb)
        back = _rgbe_decode(e)
        # shared-exponent format: error bound is max_component / 256
        tol = rgb.max(axis=-1, keepdims=True) / 128.0
        assert np.all(np.abs(back - rgb) <= tol)
