"""Host-side C++ pillar decoration, bound with ctypes.

Counterpart of ``gencomm_tpu/native`` (``PillarVoxelizer.decorate`` and
``decorate_batch``). ``voxelizer.cpp`` is the port's own copy; it is built
with ``g++`` into ``build/native`` beside the package at first use, and a
failed build raises. ``_decorate_numpy`` is the numpy reference the tests
hold the C++ path against; it is never a silent fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_THIS_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_THIS_DIR, "voxelizer.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_THIS_DIR)),
                          "build", "native")
_SO_PATH = os.path.join(_BUILD_DIR, "libvoxelizer.so")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_SO_PATH)
            or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC_PATH)):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
        proc = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC_PATH,
             "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC_PATH}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, _SO_PATH)
    lib = ctypes.CDLL(_SO_PATH)
    f32 = ctypes.POINTER(ctypes.c_float)
    i32 = ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.decorate_pillars.argtypes = [
        f32, ctypes.c_int64, f32, f32, ctypes.c_int32, f32, i32, f32, i32, u8]
    lib.decorate_pillars.restype = None
    lib.decorate_pillars_batch.argtypes = [
        f32, ctypes.c_int32, ctypes.c_int64, f32, f32, ctypes.c_int32, f32,
        i32, f32, i32, u8]
    lib.decorate_pillars_batch.restype = None
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class PillarVoxelizer:
    """Per-point pillar decoration: (P, 4) points -> (P, 10) features
    [xyzi | xyz - pillar mean | xyz - pillar centre], flat pillar ids
    iy*nx+ix and a valid mask, rows sorted by id with invalid rows
    (id nx*ny, zero features) last."""

    def __init__(self, pc_range, voxel_size):
        self.pc_range = np.asarray(pc_range, np.float32)
        self.voxel_size = np.asarray(voxel_size, np.float32)
        nx = int(round((pc_range[3] - pc_range[0]) / voxel_size[0]))
        ny = int(round((pc_range[4] - pc_range[1]) / voxel_size[1]))
        nz = int(round((pc_range[5] - pc_range[2]) / voxel_size[2]))
        self.grid = (nx, ny, nz)
        self._batch_sums = None
        self._batch_touched = None

    def decorate_batch(self, points: np.ndarray):
        """points (A, P, 4) -> feats (A, P, 10), gids (A, P), valid (A, P);
        one host thread per agent."""
        points = np.ascontiguousarray(points, np.float32)
        a, p, d = points.shape
        if d != 4:
            raise ValueError(f"points must be (A, P, 4), got {points.shape}")
        nx, ny, _ = self.grid
        lib = _load()
        feats = np.empty((a, p, 10), np.float32)
        gids = np.empty((a, p), np.int32)
        valid = np.empty((a, p), np.uint8)
        if self._batch_sums is None or self._batch_sums.shape[0] < a:
            self._batch_sums = np.zeros((a, nx * ny, 4), np.float32)
            self._batch_touched = np.empty((a, nx * ny), np.int32)
        lib.decorate_pillars_batch(
            _ptr(points, ctypes.c_float), a, p,
            _ptr(self.pc_range, ctypes.c_float),
            _ptr(self.voxel_size, ctypes.c_float), nx * ny,
            _ptr(self._batch_sums, ctypes.c_float),
            _ptr(self._batch_touched, ctypes.c_int32),
            _ptr(feats, ctypes.c_float), _ptr(gids, ctypes.c_int32),
            _ptr(valid, ctypes.c_uint8))
        return feats, gids, valid.astype(bool)

    def _decorate_numpy(self, points: np.ndarray):
        """Numpy reference of one agent's decoration: (P, 4) -> feats
        (P, 10), gids (P,), valid (P,)."""
        points = np.ascontiguousarray(points, np.float32)
        pr, vs = self.pc_range, self.voxel_size
        nx, ny, _ = self.grid
        xyz = points[:, :3]
        inb = np.all((xyz >= pr[:3]) & (xyz < pr[3:]), axis=1) & (
            points[:, 2] <= pr[5])
        ix = np.minimum(((points[:, 0] - pr[0]) / vs[0]).astype(np.int64), nx - 1)
        iy = np.minimum(((points[:, 1] - pr[1]) / vs[1]).astype(np.int64), ny - 1)
        cell = np.where(inb, iy * nx + ix, nx * ny)
        sums = np.zeros((nx * ny + 1, 4), np.float64)
        np.add.at(sums, cell, np.concatenate(
            [xyz, np.ones((len(points), 1))], axis=1) * inb[:, None])
        mean = sums[:, :3] / np.maximum(sums[:, 3:4], 1.0)
        cx = (ix + 0.5) * vs[0] + pr[0]
        cy = (iy + 0.5) * vs[1] + pr[1]
        cz = np.full_like(cx, 0.5 * vs[2] + pr[2], dtype=np.float64)
        feats = np.empty((len(points), 10), np.float32)
        feats[:, :4] = points
        feats[:, 4:7] = xyz - mean[cell]
        feats[:, 7] = points[:, 0] - cx
        feats[:, 8] = points[:, 1] - cy
        feats[:, 9] = points[:, 2] - cz
        feats[~inb] = 0.0
        order = np.argsort(cell, kind="stable")
        return feats[order], cell[order].astype(np.int32), inb[order]
