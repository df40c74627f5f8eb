"""Native .vdb round-trip: the from-scratch OpenVDB archive writer
(scene/vdb.py write_vdb) against the native C++ reader
(csrc/cvr_vdb.cpp via utils/native), with the reference VDBAdapter's
densify semantics (active bbox, inactive = 0)."""

import numpy as np
import pytest

from cudavolumerenderer_tpu.scene import vdb
from cudavolumerenderer_tpu.utils import native


@pytest.fixture(autouse=True)
def native_library():
    """Build (or find) the native reader when a test runs, not while the
    module is collected: collection in several workers must not run make."""
    if not native.available():
        pytest.skip(f"native library unavailable: {native._BUILD_ERROR}")


def sparse_volume(shape=(21, 29, 37), seed=5):
    rs = np.random.RandomState(seed)
    d = rs.rand(*shape).astype(np.float32)
    d[d < 0.7] = 0.0  # sparsity incl. fully-empty leaves
    d[:, 8:16, :] = 0.0
    return d


class TestVdbRoundTrip:
    @pytest.mark.parametrize("compression", ["zip", "none", "blosc"])
    def test_density_round_trip(self, tmp_path, compression):
        d = sparse_volume()
        path = str(tmp_path / f"rt_{compression}.vdb")
        vdb.write_vdb(path, d, compression=compression)
        bbox, channels = native.vdb_grid_info(path, "density")
        assert channels == 1
        got, _ = native.vdb_densify(path, "density", 1)
        # densified over the ACTIVE bbox: compare against the original
        # cropped to its nonzero extent
        nz = np.nonzero(d)
        lo = [a.min() for a in reversed(nz)]  # x, y, z
        hi = [a.max() for a in reversed(nz)]
        assert list(bbox) == lo + hi
        crop = d[lo[2]:hi[2] + 1, lo[1]:hi[1] + 1, lo[0]:hi[0] + 1]
        np.testing.assert_array_equal(got[..., 0], crop)

    def test_vec3s_albedo_round_trip(self, tmp_path):
        d = sparse_volume()
        alb = np.stack([d, 0.5 * (d > 0), 1.0 - d], axis=-1).astype(
            np.float32
        )
        alb[d == 0] = 0.0
        path = str(tmp_path / "rt3.vdb")
        vdb.write_vdb(path, d, alb)
        got, bbox = native.vdb_densify(path, "albedo", 3)
        nz = np.nonzero(d)
        lo = [a.min() for a in reversed(nz)]
        hi = [a.max() for a in reversed(nz)]
        crop = alb[lo[2]:hi[2] + 1, lo[1]:hi[1] + 1, lo[0]:hi[0] + 1]
        np.testing.assert_array_equal(got, crop)

    def test_missing_grid_raises(self, tmp_path):
        d = sparse_volume()
        path = str(tmp_path / "nogrid.vdb")
        vdb.write_vdb(path, d)
        with pytest.raises((KeyError, RuntimeError)):
            native.vdb_grid_info(path, "albedo")

    def test_load_vdb_scene(self, tmp_path):
        d = sparse_volume()
        alb = np.stack([d, d, d], axis=-1).astype(np.float32)
        path = str(tmp_path / "scene.vdb")
        vdb.write_vdb(path, d, alb)
        scene, camera = vdb.load_vdb_scene(path)
        # VDBSceneBuilder conventions (reference: VDBSceneBuilder.h:40-80)
        assert float(scene.medium.scale) == 100.0
        assert float(scene.medium.max_density) == pytest.approx(
            float(d.max())
        )
        np.testing.assert_allclose(
            np.asarray(scene.medium.box_min), [-0.5, -0.5, -0.5]
        )

    def test_larger_grid_multiple_internal2(self, tmp_path):
        # spans several Internal2 nodes (>128 voxels along x)
        rs = np.random.RandomState(9)
        d = np.zeros((17, 40, 300), np.float32)
        d[3:12, 5:30, 10:290] = (
            rs.rand(9, 25, 280).astype(np.float32) > 0.6
        ) * rs.rand(9, 25, 280).astype(np.float32)
        path = str(tmp_path / "big.vdb")
        vdb.write_vdb(path, d)
        got, bbox = native.vdb_densify(path, "density", 1)
        nzidx = np.nonzero(d)
        lo = [a.min() for a in reversed(nzidx)]
        hi = [a.max() for a in reversed(nzidx)]
        crop = d[lo[2]:hi[2] + 1, lo[1]:hi[1] + 1, lo[0]:hi[0] + 1]
        np.testing.assert_array_equal(got[..., 0], crop)


class TestBloscDecoder:
    """The from-scratch blosc1 chunk decoder (csrc/cvr_vdb.cpp) against
    the REAL system c-blosc compressor: memcpyed / split / non-split /
    multi-block / leftover-block chunks, lz4 and lz4hc, typesizes 1-8.
    Skipped when libblosc is absent (the .vdb blosc read path then
    falls back to raising, as before)."""

    @staticmethod
    def _libs():
        import ctypes
        import ctypes.util

        try:
            bl = ctypes.CDLL(
                ctypes.util.find_library("blosc") or "libblosc.so.1"
            )
        except OSError:
            pytest.skip("system libblosc not available")
        bl.blosc_compress_ctx.restype = ctypes.c_int
        cv = ctypes.CDLL(native._load()._name)
        cv.cvr_blosc_decompress.restype = ctypes.c_int
        cv.cvr_vdb_last_error.restype = ctypes.c_char_p
        return bl, cv

    @pytest.mark.parametrize("codec", [b"lz4", b"lz4hc"])
    def test_round_trip_matrix(self, codec):
        import ctypes

        bl, cv = self._libs()
        rs = np.random.RandomState(0)
        n_checked = 0
        for nel in [1, 33, 100, 512, 5000, 65536, 1 << 19]:
            for kind in ["rand", "sparse", "const", "ramp"]:
                if kind == "rand":
                    a = rs.rand(nel).astype(np.float32)
                elif kind == "sparse":
                    a = rs.rand(nel).astype(np.float32)
                    a[a < 0.7] = 0
                elif kind == "ramp":
                    a = np.arange(nel, dtype=np.float32)
                else:
                    a = np.full(nel, 3.14, np.float32)
                for ts in [4, 1, 8]:
                    data = a.tobytes()
                    if len(data) % ts:
                        continue
                    out = ctypes.create_string_buffer(len(data) + 64)
                    n = bl.blosc_compress_ctx(
                        9, 1, ts, len(data), data, out, len(data) + 64,
                        codec, 0, 1,
                    )
                    if n <= 0:
                        continue
                    dst = ctypes.create_string_buffer(len(data))
                    rc = cv.cvr_blosc_decompress(
                        out.raw[:n], n, dst, len(data)
                    )
                    assert rc == 0, (
                        nel, kind, ts,
                        cv.cvr_vdb_last_error().decode(),
                    )
                    assert dst.raw == data, (nel, kind, ts)
                    n_checked += 1
        assert n_checked > 50

    def test_rejects_unsupported_codec(self):
        import ctypes

        bl, cv = self._libs()
        data = np.arange(256, dtype=np.float32).tobytes()
        out = ctypes.create_string_buffer(len(data) + 64)
        n = bl.blosc_compress_ctx(
            9, 1, 4, len(data), data, out, len(data) + 64,
            b"blosclz", 0, 1,
        )
        if n <= 0:
            pytest.skip("blosclz unavailable in system blosc")
        dst = ctypes.create_string_buffer(len(data))
        rc = cv.cvr_blosc_decompress(out.raw[:n], n, dst, len(data))
        # memcpyed chunks decode regardless of codec; compressed
        # blosclz chunks must be rejected with a clear error
        if out.raw[2] & 0x2:
            assert rc == 0
        else:
            assert rc == -1
            assert b"codec" in cv.cvr_vdb_last_error()
