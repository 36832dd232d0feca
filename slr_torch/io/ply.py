"""PLY / OBJ point-cloud IO (port of ``slr/io/ply.py``).

Binary-little-endian PLY, readable by MeshLab, CloudCompare and Open3D.
``write_ply`` and ``read_ply`` go through the port's native C++ writer
(``slr_torch/native/plyio.cpp``: one interleave pass and one fwrite),
built by g++ into ``slr_torch/kernels/_build/`` at first use. Unlike the
reference, which falls back to NumPy without a word when its build fails,
a failed build raises with g++'s log. ``write_ply_numpy`` and
``read_ply_numpy`` are the plain versions the tests hold it to; a file
written by either is the reference's byte for byte.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from slr_torch.io.checkpoint import as_numpy
from slr_torch.kernels.build import build_host_library

NATIVE_SRC = Path(__file__).resolve().parent.parent / "native" / "plyio.cpp"

_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.cache
def library() -> ctypes.CDLL:
    """The native PLY library, built from ``NATIVE_SRC`` on first use."""
    lib = ctypes.CDLL(str(build_host_library(NATIVE_SRC)[0]))
    lib.slr_write_ply.restype = ctypes.c_int
    lib.slr_write_ply.argtypes = [ctypes.c_char_p, ctypes.c_int64, _F32P, _U8P, _F32P]
    lib.slr_ply_info.restype = ctypes.c_int64
    lib.slr_ply_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.slr_read_ply.restype = ctypes.c_int
    lib.slr_read_ply.argtypes = [ctypes.c_char_p, ctypes.c_int64, _F32P, _U8P, _F32P]
    return lib


def _as_compact(points, mask=None, colors=None, normals=None):
    """(points, uint8 colours or None, normals or None), masked and
    contiguous. Float colours are scaled by 255 when their maximum is at
    most 1 + 1e-6, clipped to [0, 255] and truncated to uint8, as the
    reference does."""
    pts = np.ascontiguousarray(as_numpy(points), np.float32).reshape(-1, 3)
    col = None if colors is None else as_numpy(colors).reshape(-1, 3)
    nrm = None if normals is None else np.asarray(as_numpy(normals), np.float32).reshape(-1, 3)
    if mask is not None:
        m = as_numpy(mask).reshape(-1).astype(bool)
        pts = pts[m]
        col = None if col is None else col[m]
        nrm = None if nrm is None else nrm[m]
    if col is not None and col.dtype != np.uint8:
        col = np.clip(col * 255.0 if col.max() <= 1.0 + 1e-6 else col, 0, 255
                      ).astype(np.uint8)
    return (np.ascontiguousarray(pts),
            None if col is None else np.ascontiguousarray(col),
            None if nrm is None else np.ascontiguousarray(nrm))


def _fields(has_rgb: bool, has_nrm: bool):
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if has_nrm:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if has_rgb:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    return fields


def write_ply(path, points, mask=None, colors=None, normals=None) -> int:
    """Write a point cloud through the native writer; returns the number of
    points written.

    points (N,3) or (H,W,3), tensors or arrays; mask optional (same leading
    shape) selects valid points; colors uint8/float (N,3); normals f32
    (N,3). Raises ``OSError`` when the file cannot be written.
    """
    pts, col, nrm = _as_compact(points, mask, colors, normals)
    rc = library().slr_write_ply(
        str(path).encode(), pts.shape[0], pts.ctypes.data_as(_F32P),
        None if col is None else col.ctypes.data_as(_U8P),
        None if nrm is None else nrm.ctypes.data_as(_F32P))
    if rc != 0:
        raise OSError(f"slr_write_ply failed ({rc}) for {path}")
    return pts.shape[0]


def write_ply_numpy(path, points, mask=None, colors=None, normals=None) -> int:
    """``write_ply``'s plain version: a NumPy structured array."""
    pts, col, nrm = _as_compact(points, mask, colors, normals)
    n = pts.shape[0]
    rec = np.empty(n, dtype=_fields(col is not None, nrm is not None))
    rec["x"], rec["y"], rec["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if nrm is not None:
        rec["nx"], rec["ny"], rec["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
    if col is not None:
        rec["red"], rec["green"], rec["blue"] = col[:, 0], col[:, 1], col[:, 2]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"comment slr tpu-native structured-light engine\n")
        f.write(f"element vertex {n}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        if nrm is not None:
            f.write(b"property float nx\nproperty float ny\nproperty float nz\n")
        if col is not None:
            f.write(b"property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(b"end_header\n")
        rec.tofile(f)
    return n


def read_ply(path):
    """Read a PLY of ``write_ply``'s layout through the native reader.
    Returns numpy (points, colors, normals), None for absent attributes."""
    lib = library()
    has_rgb, has_nrm = ctypes.c_int(0), ctypes.c_int(0)
    n = lib.slr_ply_info(str(path).encode(), ctypes.byref(has_rgb), ctypes.byref(has_nrm))
    if n < 0:
        raise OSError(f"not a readable PLY: {path}")
    pts = np.empty((n, 3), np.float32)
    col = np.empty((n, 3), np.uint8) if has_rgb.value else None
    nrm = np.empty((n, 3), np.float32) if has_nrm.value else None
    rc = lib.slr_read_ply(
        str(path).encode(), n, pts.ctypes.data_as(_F32P),
        None if col is None else col.ctypes.data_as(_U8P),
        None if nrm is None else nrm.ctypes.data_as(_F32P))
    if rc != 0:
        raise OSError(f"slr_read_ply failed ({rc}) for {path}")
    return pts, col, nrm


def read_ply_numpy(path):
    """``read_ply``'s plain version (the same restricted layout)."""
    with open(path, "rb") as f:
        has_rgb = has_nrm = False
        n = 0
        while True:
            line = f.readline().decode("ascii", "ignore")
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property float nx"):
                has_nrm = True
            elif line.startswith("property uchar red"):
                has_rgb = True
            elif line.startswith("end_header"):
                break
        rec = np.fromfile(f, dtype=_fields(has_rgb, has_nrm), count=n)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
    nrm = np.stack([rec["nx"], rec["ny"], rec["nz"]], axis=1) if has_nrm else None
    col = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1) if has_rgb else None
    return pts, col, nrm


def write_obj(path, points, mask=None, colors=None) -> int:
    """Minimal OBJ vertex export (v x y z [r g b])."""
    pts, col, _ = _as_compact(points, mask, colors)
    with open(path, "w") as f:
        f.write("# slr tpu-native structured-light engine\n")
        if col is None:
            for p in pts:
                f.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        else:
            cf = col.astype(np.float32) / 255.0
            for p, c in zip(pts, cf):
                f.write(
                    f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f}\n"
                )
    return pts.shape[0]
