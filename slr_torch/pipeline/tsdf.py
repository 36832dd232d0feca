"""TSDF volume fusion and marching-tetrahedra surface extraction (port of
``slr/pipeline/tsdf.py``).

Registered scans are integrated into a truncated-signed-distance volume
(Curless-Levoy weighted averaging): every voxel centre is projected into
the scan camera, the organized depth map is sampled bilinearly, and the
tsdf, weight and colour are updated in place, one dense pass a scan. The
surface is the zero crossing, extracted by marching tetrahedra (6 tets a
cube, a 16-case table with no ambiguous cases) over the active cubes,
which are compacted on the device.
"""

from __future__ import annotations

import warnings
from typing import List, NamedTuple

import numpy as np
import torch

from slr_torch import observability as obs
from slr_torch.geom.camera import Camera, project
from slr_torch.kernels import obj_text
from slr_torch.pipeline.reconstruct import ScanCloud


class TSDFVolume(NamedTuple):
    tsdf: torch.Tensor     # (D, H, W) f32 in [-1, 1], +1 (empty) at first
    weight: torch.Tensor   # (D, H, W) f32 accumulated integration weight
    color: torch.Tensor    # (D, H, W) f32 accumulated intensity
    origin: torch.Tensor   # (3,) world position of the centre of voxel (0, 0, 0)
    voxel: torch.Tensor    # () voxel edge length
    trunc: torch.Tensor    # () truncation distance


def make_volume(origin, size_vox=(128, 128, 128), voxel: float = 2.0,
                trunc: float | None = None, device=None) -> TSDFVolume:
    """Empty volume on ``device`` (default: ``origin``'s, or the CPU for an
    array); grid index order (z, y, x) -> axes (D, H, W)."""
    origin = obs.upload("tsdf.upload", origin, device, torch.float32)
    dev = origin.device
    D, H, W = size_vox
    if trunc is None:
        trunc = 3.0 * voxel

    def scalar(x):
        return obs.upload("tsdf.upload", x, dev, torch.float32)

    return TSDFVolume(tsdf=torch.ones((D, H, W), device=dev),
                      weight=torch.zeros((D, H, W), device=dev),
                      color=torch.zeros((D, H, W), device=dev),
                      origin=origin, voxel=scalar(voxel), trunc=scalar(trunc))


def volume_from_numpy(tsdf, weight, color, origin, voxel, trunc, device="cpu") -> TSDFVolume:
    """A volume given as numpy arrays (the JAX ``TSDFVolume`` after
    ``jax.tree.map(np.asarray, vol)``) -> the port's ``TSDFVolume``."""
    return TSDFVolume(*(torch.as_tensor(np.array(x, np.float32), device=device)
                        for x in (tsdf, weight, color, origin, voxel, trunc)))


def _voxel_centers(vol: TSDFVolume):
    """(D, H, W, 3) world (x, y, z) of every voxel centre."""
    D, H, W = vol.tsdf.shape
    z, y, x = torch.meshgrid(*(torch.arange(n, dtype=torch.float32, device=vol.tsdf.device)
                               for n in (D, H, W)), indexing="ij")
    return vol.origin + vol.voxel * torch.stack([x, y, z], dim=-1)


def _bilinear_packed(packed, u, v, max_spread):
    """Valid-aware bilinear sample of a packed (H, W, 3) map of [depth,
    valid, color] at float pixel coords. Returns (depth, ok, color): ok when
    the coordinate is in bounds, all four support pixels are valid, and
    their depths span at most ``max_spread`` (no interpolating across a
    silhouette into phantom surface)."""
    H, W = packed.shape[:2]
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    u = torch.clamp(u, 0.0, W - 1.0)
    v = torch.clamp(v, 0.0, H - 1.0)
    x0 = torch.floor(u).to(torch.int64)
    y0 = torch.floor(v).to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    fx = (u - x0)[..., None]
    fy = (v - y0)[..., None]
    flat = packed.reshape(-1, 3)
    s00, s01 = flat[y0 * W + x0], flat[y0 * W + x1]
    s10, s11 = flat[y1 * W + x0], flat[y1 * W + x1]
    ok = inb & ((s00[..., 1] * s01[..., 1] * s10[..., 1] * s11[..., 1]) > 0.5)
    d_hi = torch.maximum(torch.maximum(s00[..., 0], s01[..., 0]),
                         torch.maximum(s10[..., 0], s11[..., 0]))
    d_lo = torch.minimum(torch.minimum(s00[..., 0], s01[..., 0]),
                         torch.minimum(s10[..., 0], s11[..., 0]))
    ok = ok & ((d_hi - d_lo) <= max_spread)
    s = (s00 * (1 - fx) * (1 - fy) + s01 * fx * (1 - fy)
         + s10 * (1 - fx) * fy + s11 * fx * fy)
    return s[..., 0], ok, s[..., 2]


def tsdf_integrate(vol: TSDFVolume, cloud: ScanCloud, cam: Camera, R_s, t_s) -> TSDFVolume:
    """Integrate one registered scan into the volume.

    ``cloud`` is the organized scan in its own rig (camera) frame; (R_s, t_s)
    maps the scan frame to the volume's (anchor) frame, the pose that
    registration recovers; ``cam`` is the scan camera at the rig origin.
    The weight tapers linearly behind the surface (from 1 at the surface to
    0.05 at -trunc) for a crisp zero crossing.
    """
    pts_w = _voxel_centers(vol)
    pts_c = torch.einsum("ji,...j->...i", R_s, pts_w - t_s)     # volume -> scan frame
    uv, z_vox = project(cam, pts_c)
    packed = torch.stack([cloud.points[..., 2], cloud.mask.to(torch.float32),
                          cloud.colors], dim=-1)
    depth, ok, col = _bilinear_packed(packed, uv[..., 0], uv[..., 1], vol.trunc)
    sdf = depth - z_vox                                          # + in front of the surface
    upd = ok & (z_vox > 0) & (sdf > -vol.trunc)
    tsdf_new = torch.clamp(sdf / vol.trunc, -1.0, 1.0)
    w_new = torch.where(upd, torch.clamp(1.0 + sdf / vol.trunc, 0.05, 1.0), 0.0)
    w_tot = vol.weight + w_new
    denom = torch.where(w_tot > 0, w_tot, 1.0)
    seen = w_tot > 0
    tsdf = torch.where(seen, (vol.tsdf * vol.weight + tsdf_new * w_new) / denom, vol.tsdf)
    color = torch.where(seen, (vol.color * vol.weight + col * w_new) / denom, vol.color)
    return vol._replace(tsdf=tsdf, weight=w_tot, color=color)


def fuse_tsdf(clouds: List[ScanCloud], cam: Camera, Rs, ts, size_vox=(128, 128, 128),
              voxel: float = 2.0, origin=None, margin: float = 10.0) -> TSDFVolume:
    """Fuse registered scans into one TSDF volume on the clouds' device.

    Rs, ts: per-scan poses (scan frame -> anchor frame), e.g. from
    ``register_scans`` or ``ba_refine``. With ``origin`` None the volume is
    centred on the anchor scan's valid points, ``margin`` around them: their
    bounds are taken on the device and read to the host (six numbers). A
    scene wider than the volume grows the voxel edge, with a warning, rather
    than cropping the model; an anchor scan with no valid point raises
    ``ValueError``.
    """
    with obs.span("tsdf"):
        dev = clouds[0].points.device
        if origin is None:
            p, m = clouds[0].points, clouds[0].mask[..., None]
            b = torch.cat([torch.where(m, p, float("inf")).amin(dim=(0, 1)),
                           torch.where(m, p, float("-inf")).amax(dim=(0, 1))])
            with obs.wait("tsdf.bounds"):
                b = b.cpu().numpy()
            if not np.isfinite(b).all():
                raise ValueError("fuse_tsdf: anchor scan has no valid points — cannot "
                                 "auto-place the volume (pass origin= explicitly)")
            lo, hi = b[:3] - margin, b[3:] + margin
            D, H, W = size_vox
            span = hi - lo
            need = np.array([W, H, D], np.float32) * voxel
            if np.any(span > need):
                grow = float(np.max(span / need))
                voxel = voxel * grow
                need = need * grow
                warnings.warn(f"fuse_tsdf: scene span {span} exceeds the {size_vox} x "
                              f"{voxel / grow:.3g} volume; growing voxel size to "
                              f"{voxel:.3g} to fit", stacklevel=2)
            origin = lo - np.maximum(need - span, 0.0) / 2.0
        vol = make_volume(origin, size_vox=size_vox, voxel=voxel, device=dev)
        for s, c in enumerate(clouds):
            with obs.span("tsdf.integrate"):
                vol = tsdf_integrate(
                    vol, c, cam, torch.as_tensor(Rs[s], dtype=torch.float32, device=dev),
                    torch.as_tensor(ts[s], dtype=torch.float32, device=dev))
        return vol


# --- marching tetrahedra ---------------------------------------------------

# cube corner offsets (x, y, z), standard order
_CUBE = [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
         (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)]
# 6-tetrahedra decomposition of the cube around the 0-6 diagonal
_TETS = [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
         [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]]
# tet edges: pairs of tet-local corner indices
_EDGES = [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]]
# case -> up to 2 triangles of edge indices (-1 = unused); bit i of the case
# is set when tet corner i is inside (value < 0)
_TRI_TABLE = -np.ones((16, 2, 3), np.int64)
_TRI_TABLE[0b0001] = [[0, 1, 2], [-1, -1, -1]]
_TRI_TABLE[0b0010] = [[0, 4, 3], [-1, -1, -1]]
_TRI_TABLE[0b0100] = [[1, 3, 5], [-1, -1, -1]]
_TRI_TABLE[0b1000] = [[2, 5, 4], [-1, -1, -1]]
_TRI_TABLE[0b0011] = [[1, 2, 4], [1, 4, 3]]
_TRI_TABLE[0b0101] = [[0, 3, 5], [0, 5, 2]]
_TRI_TABLE[0b1001] = [[0, 1, 5], [0, 5, 4]]
_TRI_TABLE[0b0110] = [[0, 4, 5], [0, 5, 1]]
_TRI_TABLE[0b1010] = [[0, 2, 5], [0, 5, 3]]
_TRI_TABLE[0b1100] = [[1, 3, 4], [1, 4, 2]]
# 0b0111 is the complement of 0b1000 and must carry the reversed winding
# (the same three edge points, the other side of the surface): [2,4,5]
_TRI_TABLE[0b0111] = [[2, 4, 5], [-1, -1, -1]]
_TRI_TABLE[0b1011] = [[1, 5, 3], [-1, -1, -1]]
_TRI_TABLE[0b1101] = [[0, 3, 4], [-1, -1, -1]]
_TRI_TABLE[0b1110] = [[0, 2, 1], [-1, -1, -1]]


def _corners(a, dx: int, dy: int, dz: int):
    """``a`` at corner (dx, dy, dz) of every cube: (D-1, H-1, W-1)."""
    D, H, W = a.shape
    return a[dz:D - 1 + dz, dy:H - 1 + dy, dx:W - 1 + dx]


def _active_cubes(vol: TSDFVolume):
    """Cubes whose 8 corners are all observed and not all of one sign:
    (D-1, H-1, W-1) bool."""
    seen, lo, hi = None, None, None
    for c in _CUBE:
        w, t = _corners(vol.weight, *c) > 0, _corners(vol.tsdf, *c)
        if seen is None:
            seen, lo, hi = w, t, t
        else:
            seen, lo, hi = seen & w, torch.minimum(lo, t), torch.maximum(hi, t)
    return seen & (lo < 0.0) & (hi >= 0.0)


def _march_tets(vol: TSDFVolume, cube_idx):
    """Marching tetrahedra over the active cubes ``cube_idx`` (n, 3), each
    the (z, y, x) of a cube's low corner. Returns (tris (n*12, 3, 3) world
    coordinates, valid (n*12,)), ordered by cube, tet, then triangle."""
    dev = vol.tsdf.device
    cube, tets, edges, table = (obs.upload("mesh.table", x, dev, torch.int64)
                                for x in (_CUBE, _TETS, _EDGES, _TRI_TABLE))
    cz, cy, cx = cube_idx.unbind(1)
    D, H, W = vol.tsdf.shape
    flat = vol.tsdf.reshape(-1)
    vals = torch.stack([flat[((cz + dz) * H + cy + dy) * W + cx + dx]
                        for dx, dy, dz in _CUBE], dim=-1)               # (n, 8)
    pos = torch.stack([cx, cy, cz], dim=-1)[:, None, :].to(torch.float32) + cube.to(
        torch.float32)[None]                                            # (n, 8, 3)
    tv = vals[:, tets]                                                  # (n, 6, 4)
    tp = pos[:, tets]                                                   # (n, 6, 4, 3)
    inside = (tv < 0.0).to(torch.int64)
    case = inside[..., 0] + 2 * inside[..., 1] + 4 * inside[..., 2] + 8 * inside[..., 3]
    va, vb = tv[..., edges[:, 0]], tv[..., edges[:, 1]]                 # (n, 6, 6)
    pa, pb = tp[:, :, edges[:, 0]], tp[:, :, edges[:, 1]]               # (n, 6, 6, 3)
    denom = va - vb
    s = torch.clamp(va / torch.where(denom.abs() < 1e-12, 1e-12, denom), 0.0, 1.0)
    xing = pa + s[..., None] * (pb - pa)                                # edge points
    tri_e = table[case]                                                 # (n, 6, 2, 3)
    n = cube_idx.shape[0]
    tris = torch.gather(xing[:, :, None].expand(n, 6, 2, 6, 3), 3,
                        tri_e.clamp(min=0)[..., None].expand(n, 6, 2, 3, 3))
    tris = vol.origin + vol.voxel * tris
    return tris.reshape(-1, 3, 3), (tri_e[..., 0] >= 0).reshape(-1)


def _sample_color(vol: TSDFVolume, verts):
    """Trilinear sample of the integrated intensity at world points (N, 3)."""
    g = (verts - vol.origin) / vol.voxel                                # (x, y, z)
    D, H, W = vol.color.shape
    x = torch.clamp(g[:, 0], 0.0, W - 1.0)
    y = torch.clamp(g[:, 1], 0.0, H - 1.0)
    z = torch.clamp(g[:, 2], 0.0, D - 1.0)
    x0, y0, z0 = (torch.floor(a).to(torch.int64) for a in (x, y, z))
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    z1 = torch.clamp(z0 + 1, max=D - 1)
    fx, fy, fz = x - x0, y - y0, z - z0
    c = vol.color
    out = 0.0
    for zz, wz in ((z0, 1 - fz), (z1, fz)):
        for yy, wy in ((y0, 1 - fy), (y1, fy)):
            for xx, wx in ((x0, 1 - fx), (x1, fx)):
                out = out + c[zz, yy, xx] * (wz * wy * wx)
    return out


def extract_mesh(vol: TSDFVolume, with_colors: bool = False):
    """Zero-crossing triangle soup of the volume, on the volume's device.

    Returns (verts (N, 3) float32, faces (N // 3, 3) int32[, colors (N,)
    float32]); vertices are unwelded (each face owns its 3). The active
    cubes are compacted on the device in (z, y, x) order (one read of their
    count), and exactly those are marched, so the faces come out in the
    reference's order.
    """
    dev = vol.tsdf.device
    with obs.span("mesh.extract"):
        active = _active_cubes(vol)
        with obs.wait("mesh.count"):
            idx = torch.nonzero(active)
        tris, ok = _march_tets(vol, idx)
        with obs.wait("mesh.mask"):
            verts = tris[ok]
        verts = verts.reshape(-1, 3)
        faces = torch.arange(verts.shape[0], dtype=torch.int32, device=dev).reshape(-1, 3)
        if with_colors:
            return verts, faces, _sample_color(vol, verts)
        return verts, faces


def write_tsdf_mesh_obj(path, vol: TSDFVolume, with_colors: bool = True) -> tuple[int, int]:
    """Extract and write the fused surface as OBJ; returns (n_verts,
    n_faces). Vertex colours (the integrated white-frame intensity, clipped
    to [0, 1]) ride along as the common 'v x y z r g b' extension. The text
    is formatted where the mesh lies (``slr_torch.kernels.obj_text``: on
    the card by its kernels), read to the host once, and written in one
    binary write: the bytes of Python's f-strings, '{:.6f}' for positions
    and '{:.4f}' for colours."""
    with obs.span("mesh_write"):
        if with_colors:
            verts, faces, cols = extract_mesh(vol, with_colors=True)
            cols = torch.clamp(cols, 0.0, 1.0)
        else:
            (verts, faces), cols = extract_mesh(vol), None
        with obs.span("mesh.text"):
            ends = obj_text.line_ends(verts, cols, faces)
        with obs.wait("mesh.read"):
            n_bytes = obj_text.text_length(ends)
        with obs.span("mesh.text"):
            text = obj_text.write_text(verts, cols, faces, ends, n_bytes)
        with obs.wait("mesh.read"):
            text = obj_text.to_host(text)
        with obs.span("mesh.file"), open(path, "wb") as fh:
            fh.write(b"# slr tsdf mesh export\n")
            fh.write(text.numpy())
        return int(verts.shape[0]), int(faces.shape[0])
