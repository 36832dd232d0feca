"""Plain reference of a fused model, written from the method's definition
in plain PyTorch, and its judges. It imports nothing of the program and
takes nothing the program made except the poses it judges: it fuses the
reference's own decoded clouds (``reference/scan.py``) under given poses.

The method (the program's stated contract, ``slr_torch/pipeline/
registerfuse.py::fuse_scans``, ``registration/voxel.py::voxel_downsample``
and ``pipeline/tsdf.py``'s docstrings):

- the voxel fuse: every valid point taken to the anchor frame, ``R p + t``;
  its voxel ``floor(p / edge)``; points outside the 1024-voxel window at the
  per-axis least voxel dropped; each voxel the mean of its points; the
  ``capacity`` voxels of least packed id (x fastest, then y, then z) kept;
- the TSDF: a (D, H, W) grid of ``edge`` around the anchor scan's valid
  points with a 10 mm margin, the edge grown to hold them, centred; the
  truncation three edges; each voxel centre taken to each scan's frame,
  ``R^T (p - t)``, projected by the camera's intrinsics (the camera at the
  rig's origin, no lens distortion), the scan's depth sampled bilinearly
  where the four pixels are valid and span at most the truncation; the sdf
  ``depth - z`` updates voxels in front of the camera and less than the
  truncation behind the surface, with the weight ``clamp(1 + sdf / trunc,
  0.05, 1)``, Curless-Levoy averaged;
- the mesh: marching tetrahedra over the cubes whose 8 corners have weight
  and are not all of one sign (inside: below 0), 6 tetrahedra a cube around
  its 0-6 diagonal; a vertex where a tetrahedron's edge joins an inside and
  an outside corner, at the linear zero; one triangle for 1 or 3 inside
  corners, two for 2.

Computed in float64. ``tf32=True`` is the control: float32, with the
operands of every matrix product (the pose, the projection) rounded to
TF32, as the tensor cores do.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.scan import round_tf32

_WINDOW = 1024          # voxels a side of the fuse's packing window
_OFF = 1 << 20          # offset of a voxel coordinate in a comparison key


class Fused(NamedTuple):
    vox: torch.Tensor      # (M, 3) int64 voxel (x, y, z)
    means: torch.Tensor    # (M, 3) the voxels' mean points


class Mesh(NamedTuple):
    verts: torch.Tensor    # (V, 3) every vertex position (repeats allowed)
    faces: int             # triangles


def pose_error(R, t, R_true, t_true):
    """(rotation error in degrees, translation error in mm), in float64;
    the angle from |R - R_true|_F = 2 sqrt(2) sin(angle / 2)."""
    dR = torch.linalg.norm(R.double().cpu() - R_true.double().cpu())
    ang = 2.0 * math.asin(min(float(dR) / (2.0 * math.sqrt(2.0)), 1.0))
    return math.degrees(ang), float(torch.linalg.norm(t.double().cpu() - t_true.double().cpu()))


def _mm(a, b, tf32: bool):
    if tf32:
        return round_tf32(a.float()) @ round_tf32(b.float())
    return a.double() @ b.double()


def _dtype(tf32: bool):
    return torch.float32 if tf32 else torch.float64


def voxel_fuse(clouds, Rs, ts, edge: float, capacity: int, tf32: bool = False) -> Fused:
    """The voxel fuse of the organized ``clouds`` (points, mask) under the
    poses (scan -> anchor)."""
    dt = _dtype(tf32)
    pts = torch.cat([_mm(c.points[c.mask], torch.as_tensor(R).to(c.points.device).T, tf32)
                     + torch.as_tensor(t).to(c.points.device, dt)
                     for c, R, t in zip(clouds, Rs, ts)])
    v = torch.floor(pts / edge).to(torch.int64)
    w = v - v.amin(dim=0)
    keep = (w < _WINDOW).all(dim=1)
    pts, v, w = pts[keep], v[keep], w[keep]
    vid = w[:, 0] + _WINDOW * (w[:, 1] + _WINDOW * w[:, 2])
    ids, inv = torch.unique(vid, sorted=True, return_inverse=True)
    sums = torch.zeros(ids.numel(), 3, dtype=dt, device=pts.device).index_add_(0, inv, pts)
    cnt = torch.bincount(inv, minlength=ids.numel()).to(dt)
    vox = torch.zeros(ids.numel(), 3, dtype=torch.int64, device=pts.device)
    vox[inv] = v
    return Fused(vox[:capacity], (sums / cnt[:, None])[:capacity])


def _key(vox):
    v = vox + _OFF
    return v[:, 0] + (v[:, 1] << 21) + (v[:, 2] << 42)


def fused_off_share(means, ref: Fused, edge: float, tol: float) -> float:
    """The share, over the reference's voxels, of voxels that the judged
    fuse's voxel means ``means`` (K, 3) miss, add, repeat, or place more
    than ``tol`` from the reference's mean. A mean lies inside its voxel,
    so its voxel is ``floor(mean / edge)``."""
    dev = ref.means.device
    m = means.to(dev, torch.float64)
    kp = _key(torch.floor(m / edge).to(torch.int64))
    kr, order = torch.sort(_key(ref.vox))
    mr = ref.means[order].double()
    if kr.numel() == 0:
        return 1.0
    i = torch.searchsorted(kr, kp).clamp(max=kr.numel() - 1)
    hit = kr[i] == kp
    close = hit & (torch.linalg.norm(m - mr[i], dim=1) <= tol)
    first = torch.zeros(kr.numel(), dtype=torch.bool, device=dev)
    first[i[hit]] = True
    repeats = int(hit.sum()) - int(first.sum())
    off = int((~close).sum()) + int((~first).sum()) + repeats
    return off / kr.numel()


class Volume(NamedTuple):
    tsdf: torch.Tensor     # (D, H, W)
    weight: torch.Tensor   # (D, H, W)
    origin: torch.Tensor   # (3,) centre of voxel (0, 0, 0), (x, y, z)
    edge: float


def tsdf_volume(clouds, intrinsics, Rs, ts, size_vox, edge: float, margin: float = 10.0,
                tf32: bool = False) -> Volume:
    """The TSDF of the organized ``clouds`` under the poses; ``intrinsics``
    (fx, fy, cx, cy) of the camera at the rig's origin."""
    dt = _dtype(tf32)
    dev = clouds[0].points.device
    p0 = clouds[0].points[clouds[0].mask].to(dt)
    if p0.shape[0] == 0:
        raise ValueError("the anchor scan has no valid point")
    lo, hi = p0.amin(dim=0) - margin, p0.amax(dim=0) + margin
    D, H, W = size_vox
    span = hi - lo
    need = torch.tensor([W, H, D], dtype=dt, device=dev) * edge
    if bool((span > need).any()):
        grow = float((span / need).max())
        edge, need = edge * grow, need * grow
    origin = lo - torch.clamp(need - span, min=0.0) / 2.0
    trunc = 3.0 * edge
    z, y, x = torch.meshgrid(*(torch.arange(n, dtype=dt, device=dev) for n in (D, H, W)),
                             indexing="ij")
    centres = (origin + edge * torch.stack([x, y, z], dim=-1)).reshape(-1, 3)
    fx, fy, cx, cy = intrinsics
    K_t = torch.tensor([[fx, 0.0, 0.0], [0.0, fy, 0.0], [cx, cy, 1.0]], dtype=dt, device=dev)
    tsdf = torch.ones(D * H * W, dtype=dt, device=dev)
    weight = torch.zeros_like(tsdf)
    for c, R, t in zip(clouds, Rs, ts):
        R = torch.as_tensor(R).to(dev)
        t = torch.as_tensor(t).to(dev, dt)
        pc = _mm(centres - t, R, tf32)                     # R^T (p - t), row-wise
        uvw = _mm(pc, K_t, tf32)
        u, v, zc = uvw[:, 0] / pc[:, 2], uvw[:, 1] / pc[:, 2], pc[:, 2]
        depth, ok = _bilinear(c.points[..., 2].to(dt), c.mask, u, v, trunc)
        sdf = depth - zc
        upd = ok & (zc > 0) & (sdf > -trunc)
        t_new = torch.clamp(sdf / trunc, -1.0, 1.0)
        w_new = torch.where(upd, torch.clamp(1.0 + sdf / trunc, 0.05, 1.0), 0.0)
        w_tot = weight + w_new
        seen = w_tot > 0
        tsdf = torch.where(seen, (tsdf * weight + t_new * w_new)
                           / torch.where(seen, w_tot, 1.0), tsdf)
        weight = w_tot
    return Volume(tsdf.reshape(D, H, W), weight.reshape(D, H, W), origin, edge)


def _bilinear(depth, mask, u, v, spread: float):
    """Depth at float pixel (u, v) from its four pixels, and whether it is
    taken: (u, v) inside the map, the four pixels valid, their depths within
    ``spread`` of each other."""
    H, W = depth.shape
    ok = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    u, v = torch.clamp(u, 0.0, W - 1.0), torch.clamp(v, 0.0, H - 1.0)
    x0, y0 = torch.floor(u).to(torch.int64), torch.floor(v).to(torch.int64)
    x1, y1 = torch.clamp(x0 + 1, max=W - 1), torch.clamp(y0 + 1, max=H - 1)
    a, b = u - x0, v - y0
    d = [depth[yy, xx] for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1))]
    for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)):
        ok = ok & mask[yy, xx]
    ds = torch.stack(d)
    ok = ok & ((ds.amax(dim=0) - ds.amin(dim=0)) <= spread)
    val = (d[0] * (1 - a) * (1 - b) + d[1] * a * (1 - b)
           + d[2] * (1 - a) * b + d[3] * a * b)
    return val, ok


_CORNERS = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
            (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]


def _tetrahedra():
    """The 6 tetrahedra of a cube around its 0-6 diagonal: corner 0, then
    one, two and three unit steps along the axes in each order."""
    out = []
    for axes in itertools.permutations(range(3)):
        p, tet = [0, 0, 0], [0]
        for ax in axes:
            p[ax] = 1
            tet.append(_CORNERS.index(tuple(p)))
        out.append(tet)
    return out


def mesh(vol: Volume) -> Mesh:
    """The marching-tetrahedra surface of the volume."""
    D, H, W = vol.tsdf.shape
    vals, seen = [], None
    for dx, dy, dz in _CORNERS:
        vals.append(vol.tsdf[dz:D - 1 + dz, dy:H - 1 + dy, dx:W - 1 + dx])
        w = vol.weight[dz:D - 1 + dz, dy:H - 1 + dy, dx:W - 1 + dx] > 0
        seen = w if seen is None else seen & w
    vals = torch.stack(vals, dim=-1)
    active = seen & (vals.amin(dim=-1) < 0) & (vals.amax(dim=-1) >= 0)
    idx = torch.nonzero(active)                                     # (n, 3) z, y, x
    val = vals[active]                                              # (n, 8)
    corner = torch.tensor(_CORNERS, dtype=val.dtype, device=val.device)
    pos = idx.flip(1).to(val.dtype)[:, None, :] + corner[None]      # (n, 8, 3) x, y, z
    verts, faces = [], 0
    for tet in _tetrahedra():
        tv, tp = val[:, tet], pos[:, tet]
        inside = tv < 0
        n_in = inside.sum(dim=1)
        faces += int(((n_in == 1) | (n_in == 3)).sum()) + 2 * int((n_in == 2).sum())
        for i, j in itertools.combinations(range(4), 2):
            cross = inside[:, i] != inside[:, j]
            va, vb = tv[cross, i], tv[cross, j]
            s = torch.clamp(va / (va - vb), 0.0, 1.0)
            verts.append(tp[cross, i] + s[:, None] * (tp[cross, j] - tp[cross, i]))
    v = torch.cat(verts) if verts else pos.new_zeros((0, 3))
    return Mesh(vol.origin + vol.edge * v, faces)


def _pack(c):
    return c[:, 0] + (c[:, 1] << 21) + (c[:, 2] << 42)


def miss_share(a, b, tol: float) -> float:
    """The share of ``a``'s rows (N, 3) with no row of ``b`` within ``tol``,
    in float64 on ``b``'s device; 1 where one side is empty and the other
    not. Exact: ``b`` is bucketed in cubes of edge ``tol``, so every row
    within ``tol`` of a point lies in the 27 cubes around the point's."""
    dev = b.device
    a, b = a.to(dev, torch.float64), b.to(torch.float64)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return float(a.shape[0] != b.shape[0])
    lo = torch.minimum(a.amin(dim=0), b.amin(dim=0))
    # cube coordinates, shifted by one so that a neighbour's stays >= 0
    cb = torch.floor((b - lo) / tol).to(torch.int64) + 1
    ca = torch.floor((a - lo) / tol).to(torch.int64) + 1
    if int(torch.maximum(ca.max(), cb.max())) >= (1 << 21) - 1:
        raise ValueError("miss_share: the points span too many cubes of the tolerance")
    kb, order = torch.sort(_pack(cb))
    b = b[order]
    found = torch.zeros(a.shape[0], dtype=torch.bool, device=dev)
    for off in itertools.product((-1, 0, 1), repeat=3):
        k = _pack(ca + torch.tensor(off, device=dev))
        first = torch.searchsorted(kb, k)
        n = torch.searchsorted(kb, k, right=True) - first
        for j in range(int(n.max())):
            idx = torch.clamp(first + j, max=b.shape[0] - 1)
            near = ((a - b[idx]) ** 2).sum(dim=1) <= tol * tol
            found |= (j < n) & near
    return float((~found).sum()) / a.shape[0]


def mesh_readings(got: Mesh | None, ref: Mesh, tol: float) -> dict:
    """The judged mesh against the reference's: the share of vertex
    positions either side lacks within ``tol`` (the worse side), and the
    gap of the face counts over the reference's. An unreadable mesh reads 1
    on both."""
    if got is None:
        return {"mesh_off_share": 1.0, "mesh_face_gap": 1.0}
    off = max(miss_share(got.verts, ref.verts, tol), miss_share(ref.verts, got.verts, tol))
    return {"mesh_off_share": off,
            "mesh_face_gap": abs(got.faces - ref.faces) / max(ref.faces, 1)}


def read_obj(text: str) -> Mesh | None:
    """An OBJ file's 'v x y z [r g b]' and 'f a b c' lines as the positions
    of every face's corners; None when a face names no vertex of the file
    or a position is not finite."""
    lines = text.splitlines()
    v = [ln[2:] for ln in lines if ln.startswith("v ")]
    f = [ln[2:] for ln in lines if ln.startswith("f ")]
    verts = np.array(" ".join(v).split(), dtype=np.float64).reshape(len(v), -1)[:, :3]
    faces = np.array(" ".join(f).split(), dtype=np.int64).reshape(len(f), 3)
    if faces.size and (faces.min() < 1 or faces.max() > len(v)):
        return None
    if not np.isfinite(verts).all():
        return None
    return Mesh(torch.from_numpy(verts[faces.reshape(-1) - 1]), len(f))
