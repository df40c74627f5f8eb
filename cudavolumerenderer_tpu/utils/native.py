"""ctypes bindings for the native data-path library (csrc/cvr_native.cpp).

The reference's data path is C++ (scene parsing, sparse->dense
flattening, Morton re-layout, stb image encode); ours mirrors that with a
small C++ shared library, built from csrc/ at first use in each process
(`make -C csrc`, a no-op when the library is up to date).  The array
helpers have pure-NumPy fallbacks and `available()` reports which path is
active; the .vdb reader has none, so it raises with the failed build
command instead.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_BUILD_ERROR: Optional[str] = None

BRICK_SHAPE = (4, 4, 8)  # (z, y, x) voxels = 128 entries


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def _build(csrc: str) -> Optional[str]:
    """Run make under an exclusive lock (concurrent test workers build
    once; the Makefile's atomic rename covers callers outside the lock).
    Returns None on success, else a message naming the command."""
    cmd = ["make", "-s", "-C", csrc]
    try:
        with open(os.path.join(csrc, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            proc = subprocess.run(
                cmd, capture_output=True, text=True, timeout=300
            )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"`{' '.join(cmd)}` failed: {e}"
    if proc.returncode != 0:
        return (
            f"`{' '.join(cmd)}` exited {proc.returncode}: "
            f"{proc.stderr.strip()[-2000:]}"
        )
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED, _BUILD_ERROR
    if _TRIED:
        return _LIB
    _TRIED = True
    csrc = os.path.join(_repo_root(), "csrc")
    _BUILD_ERROR = _build(csrc)
    if _BUILD_ERROR is not None:
        return None
    lib = ctypes.CDLL(os.path.join(csrc, "libcvr_native.so"))
    lib.cvr_morton_reorder.restype = ctypes.c_int
    lib.cvr_brick_pack.restype = ctypes.c_int
    lib.cvr_brick_max.restype = ctypes.c_int
    lib.cvr_rgbe_encode.restype = ctypes.c_int
    lib.cvr_normalize_u8.restype = ctypes.c_int
    _LIB = lib
    return lib


def _require() -> ctypes.CDLL:
    """The library, or a RuntimeError naming the build that failed."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"native library unavailable ({_BUILD_ERROR}); "
            ".vdb reading requires the csrc build"
        )
    return lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def morton_reorder(volume_zyx: np.ndarray) -> np.ndarray:
    """(Z,Y,X[,C]) x-fastest → Morton-ordered flat array (Volume.h
    ZYXToMortonOrder semantics; requires equal power-of-two dims)."""
    v = np.ascontiguousarray(volume_zyx, np.float32)
    nz, ny, nx = v.shape[:3]
    c = 1 if v.ndim == 3 else v.shape[3]
    lib = _load()
    out = np.empty(nx * ny * nz * c, np.float32)
    if lib is not None:
        rc = lib.cvr_morton_reorder(
            _ptr(v), _ptr(out), nx, ny, nz, c
        )
        if rc == 0:
            return out
        if rc != -1:
            raise RuntimeError(f"cvr_morton_reorder failed: {rc}")
    # NumPy fallback
    if not (nx == ny == nz and nx & (nx - 1) == 0):
        raise ValueError("morton reorder needs equal power-of-two dims")
    z, y, x = np.meshgrid(
        np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
    )

    def expand(b):
        b = (b * 0x00010001) & 0xFF0000FF
        b = (b * 0x00000101) & 0x0F00F00F
        b = (b * 0x00000011) & 0xC30C30C3
        b = (b * 0x00000005) & 0x49249249
        return b

    code = expand(x.astype(np.uint64)) * 4 + expand(
        y.astype(np.uint64)
    ) * 2 + expand(z.astype(np.uint64))
    flat = v.reshape(nx * ny * nz, c)
    out2 = np.empty_like(flat)
    out2[code.reshape(-1)] = flat
    return out2.reshape(-1)


def brick_pack(
    volume_zyx: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int, int]]:
    """(Z,Y,X[,C]) → (n_bricks, 128, C) brick-major layout + per-brick
    majorant of the last channel.  Brick = 4x4x8 (z,y,x), x-fastest —
    128 contiguous entries per brick.

    Returns (bricks, brick_max, (nbx, nby, nbz))."""
    v = np.ascontiguousarray(volume_zyx, np.float32)
    nz, ny, nx = v.shape[:3]
    c = 1 if v.ndim == 3 else v.shape[3]
    bz, by, bx = BRICK_SHAPE
    nbx, nby, nbz = -(-nx // bx), -(-ny // by), -(-nz // bz)
    n_bricks = nbx * nby * nbz
    lib = _load()
    if lib is not None:
        out = np.empty((n_bricks, 128, c), np.float32)
        bmax = np.empty((n_bricks,), np.float32)
        rc = lib.cvr_brick_pack(_ptr(v), _ptr(out), _ptr(bmax), nx, ny, nz, c)
        if rc != 0:
            raise RuntimeError(f"cvr_brick_pack failed: {rc}")
        return out, bmax, (nbx, nby, nbz)
    # NumPy fallback
    pad = np.zeros((nbz * bz, nby * by, nbx * bx, c), np.float32)
    pad[:nz, :ny, :nx] = v.reshape(nz, ny, nx, c)
    blocks = pad.reshape(nbz, bz, nby, by, nbx, bx, c)
    bricks = np.ascontiguousarray(
        blocks.transpose(0, 2, 4, 1, 3, 5, 6)
    ).reshape(n_bricks, bz * by * bx, c)
    bmax = bricks[..., -1].max(axis=1)
    return bricks, bmax.astype(np.float32), (nbx, nby, nbz)


def brick_max(density_zyx: np.ndarray) -> np.ndarray:
    v = np.ascontiguousarray(density_zyx, np.float32)
    nz, ny, nx = v.shape
    bz, by, bx = BRICK_SHAPE
    nbx, nby, nbz = -(-nx // bx), -(-ny // by), -(-nz // bz)
    lib = _load()
    out = np.empty((nbz, nby, nbx), np.float32)
    if lib is not None:
        rc = lib.cvr_brick_max(_ptr(v), _ptr(out), nx, ny, nz)
        if rc != 0:
            raise RuntimeError(f"cvr_brick_max failed: {rc}")
        return out
    _, bmax, _ = brick_pack(v)
    return bmax.reshape(nbz, nby, nbx)


def rgbe_encode(rgb: np.ndarray) -> np.ndarray:
    """Float (..., 3) → RGBE uint8 (..., 4); native when available."""
    img = np.ascontiguousarray(rgb, np.float32)
    n = int(np.prod(img.shape[:-1]))
    lib = _load()
    if lib is not None:
        out = np.empty(img.shape[:-1] + (4,), np.uint8)
        rc = lib.cvr_rgbe_encode(_ptr(img), _ptr(out), n)
        if rc != 0:
            raise RuntimeError(f"cvr_rgbe_encode failed: {rc}")
        return out
    from .image import _rgbe_encode

    return _rgbe_encode(img)


def vdb_grid_info(path: str, grid_name: str):
    """Active-voxel bbox + channel count of a grid in a .vdb archive
    (native reader, csrc/cvr_vdb.cpp).  Returns (bbox6, channels)."""
    lib = _require()
    lib.cvr_vdb_grid_info.restype = ctypes.c_int
    lib.cvr_vdb_last_error.restype = ctypes.c_char_p
    bbox = np.zeros(6, np.int32)
    channels = ctypes.c_int32(0)
    rc = lib.cvr_vdb_grid_info(
        path.encode(), grid_name.encode(), _ptr(bbox),
        ctypes.byref(channels),
    )
    if rc == -2:
        raise KeyError(f"grid {grid_name!r} has no active voxels")
    if rc != 0:
        raise RuntimeError(
            f"cvr_vdb_grid_info: {lib.cvr_vdb_last_error().decode()}"
        )
    return bbox, int(channels.value)


def vdb_densify(path: str, grid_name: str, channels: int, bbox=None):
    """Densify a .vdb grid over its active bbox (or a given bbox) into a
    (Z, Y, X, channels) float32 array — the reference VDBAdapter's
    flattening (inactive voxels = 0).  Returns (array, bbox)."""
    lib = _require()
    if bbox is None:
        bbox, file_channels = vdb_grid_info(path, grid_name)
        if file_channels != channels:
            raise RuntimeError(
                f"grid {grid_name!r} has {file_channels} channels, "
                f"expected {channels}"
            )
    bbox = np.ascontiguousarray(bbox, np.int32)
    nx = int(bbox[3] - bbox[0] + 1)
    ny = int(bbox[4] - bbox[1] + 1)
    nz = int(bbox[5] - bbox[2] + 1)
    lib.cvr_vdb_densify.restype = ctypes.c_int
    lib.cvr_vdb_last_error.restype = ctypes.c_char_p
    out = np.zeros((nz, ny, nx, channels), np.float32)
    rc = lib.cvr_vdb_densify(
        path.encode(), grid_name.encode(), _ptr(bbox), _ptr(out), channels
    )
    if rc != 0:
        raise RuntimeError(
            f"cvr_vdb_densify: {lib.cvr_vdb_last_error().decode()}"
        )
    return out, bbox
