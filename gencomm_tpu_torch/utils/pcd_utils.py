"""Point-cloud file IO and masks (numpy, host side).

Counterpart of ``gencomm_tpu/utils/pcd_utils.py``: ``read_pcd`` (ascii
and binary PCD with x / y / z / intensity fields, no pypcd), the KITTI
``.bin`` reader of V2X-Real, ``write_pcd`` (ascii), the range and ego-body
masks and the shuffle. The same ``RandomState`` gives the same shuffle as
the JAX package.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {("F", 4): "f4", ("F", 8): "f8", ("I", 4): "i4",
           ("I", 1): "i1", ("U", 4): "u4", ("U", 1): "u1"}


def read_pcd(path: str) -> np.ndarray:
    """A PCD file -> (N, 4) float32 [x, y, z, intensity]; intensity 1.0
    where the file has none, rows with a non-finite value dropped."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = [int(s) for s in header["SIZE"].split()]
        types = header["TYPE"].split()
        counts = [int(c) for c in header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()]
        n = int(header["POINTS"])
        data_kind = header["DATA"]

        if data_kind == "ascii":
            raw = np.atleast_2d(np.loadtxt(f, dtype=np.float64, max_rows=n))
            cols, ci = {}, 0
            for fld, cnt in zip(fields, counts):
                cols[fld] = raw[:, ci]
                ci += cnt
        elif data_kind == "binary":
            dtype = np.dtype([
                (fld, _DTYPES[(t, s)], (cnt,) if cnt > 1 else ())
                for fld, t, s, cnt in zip(fields, types, sizes, counts)])
            raw = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype,
                                count=n)
            cols = {fld: np.asarray(raw[fld], np.float64).reshape(n, -1)[:, 0]
                    for fld in fields}
        else:
            raise ValueError(f"unsupported PCD DATA kind: {data_kind}")

    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    inten = cols.get("intensity", np.ones(len(xyz)))
    pts = np.concatenate([xyz, np.asarray(inten).reshape(-1, 1)], axis=1)
    return pts[np.isfinite(pts).all(axis=1)].astype(np.float32)


def load_lidar_bin(path: str, zero_intensity: bool = False) -> np.ndarray:
    """A KITTI-style ``.bin`` (V2X-Real's lidar) -> (N, 4) float32, rows
    with a NaN coordinate dropped."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    pts = pts[~np.isnan(pts[:, :3]).any(axis=1)]
    if zero_intensity:
        pts[:, -1] = 0
    return pts


def write_pcd(path: str, points: np.ndarray) -> None:
    """(N, 4) points as an ascii PCD."""
    n = len(points)
    header = ("VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
              "TYPE F F F F\nCOUNT 1 1 1 1\n"
              f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
              f"POINTS {n}\nDATA ascii\n")
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, points, fmt="%.6f")


def mask_points_by_range(points: np.ndarray, limit_range) -> np.ndarray:
    """The points strictly inside the (xmin, ymin, zmin, xmax, ymax, zmax)
    box."""
    m = ((points[:, 0] > limit_range[0]) & (points[:, 0] < limit_range[3])
         & (points[:, 1] > limit_range[1]) & (points[:, 1] < limit_range[4])
         & (points[:, 2] > limit_range[2]) & (points[:, 2] < limit_range[5]))
    return points[m]


def mask_ego_points(points: np.ndarray) -> np.ndarray:
    """The points off the ego vehicle's body (x in [-1.95, 2.95], y in
    [-1.1, 1.1] removed)."""
    m = ((points[:, 0] >= -1.95) & (points[:, 0] <= 2.95)
         & (points[:, 1] >= -1.1) & (points[:, 1] <= 1.1))
    return points[~m]


def shuffle_points(points: np.ndarray,
                   rng: np.random.RandomState | None = None) -> np.ndarray:
    """The points in the order of one permutation drawn from ``rng``."""
    rng = rng or np.random
    return points[rng.permutation(len(points))]
