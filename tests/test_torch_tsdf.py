"""slr_torch.pipeline.tsdf and .meshing against the JAX reference (CPU).

Scans are analytic (a sphere's depth map, a 160 x 128 camera, numpy-seeded
colours) so both packages integrate the same organized clouds into a 32^3
volume. Tolerances, each with its reason:
- integration: float32 with the same formulas, sums of 3 products in
  another order: tsdf, weight and colour within 1e-4 on every voxel but the
  few (<= 0.1 %) whose bilinear gate (in bounds, depth spread) flips on a
  rounding of the projected coordinate;
- the volume's placement (origin, grown voxel): the same numpy arithmetic
  on the same six bounds, so equal;
- extraction from the reference's own volume (``volume_from_numpy``): the
  same face count and the faces in the same order, vertices within 1e-4
  (voxel edge 4), colours within 1e-5;
- grid_faces: equal; the OBJ writers: the same text, or parsed back
  within the printed digits.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr.geom.camera import make_camera as jmake_camera
from slr.pipeline import meshing as jmesh
from slr.pipeline import tsdf as jtsdf
from slr.pipeline.reconstruct import ScanCloud as JCloud
from slr.synth.scene import sphere_depth
from slr_torch.geom.camera import make_camera as tmake_camera
from slr_torch.pipeline import meshing as tmesh
from slr_torch.pipeline import tsdf as ttsdf
from slr_torch.pipeline.reconstruct import scan_cloud_from_numpy

torch.set_num_threads(2)

CAM_W, CAM_H = 160, 128
CENTER = np.array([0.0, 0.0, 500.0], np.float32)
RADIUS = 40.0
CAM = dict(fx=160.0, fy=160.0, cx=CAM_W / 2, cy=CAM_H / 2)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _orbit(th):
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                 np.float32)
    return R, (CENTER - R @ CENTER).astype(np.float32)


def _scan(th, seed):
    """The sphere seen from a camera orbited by ``th`` about its vertical
    axis, as numpy cloud arrays in that camera's frame, and its pose."""
    R, t = _orbit(th)
    cam = jmake_camera(**CAM)
    c = R.T @ (CENTER - t)
    depth = np.asarray(sphere_depth(cam, CAM_H, CAM_W, jnp.asarray(c), RADIUS,
                                    background=1e6))
    valid = depth < 1e5
    depth = np.where(valid, depth, 600.0).astype(np.float32)
    v, u = np.meshgrid(np.arange(CAM_H, dtype=np.float32),
                       np.arange(CAM_W, dtype=np.float32), indexing="ij")
    pts = np.stack([(u - CAM["cx"]) / CAM["fx"] * depth,
                    (v - CAM["cy"]) / CAM["fy"] * depth, depth], -1).astype(np.float32)
    col = np.random.default_rng(seed).random((CAM_H, CAM_W)).astype(np.float32)
    z = np.zeros((CAM_H, CAM_W), np.float32)
    return (pts, valid, col, z, z), (R, t)


def _jax_cloud(a):
    return JCloud(*map(jnp.asarray, a))


@pytest.fixture(scope="module")
def fused():
    """Two views fused by both packages into a 32^3 volume of 4-unit voxels,
    auto-placed around the anchor scan."""
    scans = [_scan(0.0, 1), _scan(0.5, 2)]
    Rs = [p[1][0] for p in scans]
    ts = [p[1][1] for p in scans]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        vj = jtsdf.fuse_tsdf([_jax_cloud(a) for a, _ in scans], jmake_camera(**CAM),
                             [jnp.asarray(R) for R in Rs], [jnp.asarray(t) for t in ts],
                             size_vox=(32, 32, 32), voxel=4.0)
        vt = ttsdf.fuse_tsdf([scan_cloud_from_numpy(*a) for a, _ in scans],
                             tmake_camera(**CAM), np.stack(Rs), np.stack(ts),
                             size_vox=(32, 32, 32), voxel=4.0)
    return scans, jax.tree.map(np.asarray, vj), vt


def _volumes_close(vt, vj):
    np.testing.assert_array_equal(_np(vt.origin), vj.origin)
    assert float(vt.voxel) == float(vj.voxel) and float(vt.trunc) == float(vj.trunc)
    bad = np.zeros(vj.tsdf.shape, bool)
    for f in ("tsdf", "weight", "color"):
        bad |= np.abs(_np(getattr(vt, f)) - getattr(vj, f)) > 1e-4
    assert bad.mean() <= 1e-3, bad.sum()
    return bad


def test_tsdf_integrate_matches_reference():
    """One view into a fixed volume; the second on top of the first."""
    (a1, (R1, t1)), (a2, (R2, t2)) = _scan(0.0, 3), _scan(0.6, 4)
    origin = CENTER - 64.0
    vj = jtsdf.make_volume(origin, size_vox=(32, 32, 32), voxel=4.0)
    vt = ttsdf.make_volume(origin, size_vox=(32, 32, 32), voxel=4.0)
    for a, R, t in ((a1, R1, t1), (a2, R2, t2)):
        vj = jtsdf.tsdf_integrate(vj, _jax_cloud(a), jmake_camera(**CAM), jnp.asarray(R),
                                  jnp.asarray(t))
        vt = ttsdf.tsdf_integrate(vt, scan_cloud_from_numpy(*a), tmake_camera(**CAM),
                                  torch.from_numpy(R), torch.from_numpy(t))
        _volumes_close(vt, jax.tree.map(np.asarray, vj))
    assert float((vt.weight > 0).float().mean()) > 0.02


def test_fuse_tsdf_matches_reference(fused):
    _, vj, vt = fused
    _volumes_close(vt, vj)
    assert vt.tsdf.device == torch.device("cpu") and vt.tsdf.dtype == torch.float32


def test_fuse_tsdf_empty_anchor_raises():
    a, (R, t) = _scan(0.0, 5)
    c = scan_cloud_from_numpy(*a)
    c = c._replace(mask=torch.zeros_like(c.mask))
    with pytest.raises(ValueError, match="no valid points"):
        ttsdf.fuse_tsdf([c], tmake_camera(**CAM), [torch.eye(3)], [torch.zeros(3)])


def test_fuse_tsdf_grows_voxel_as_reference():
    """A scene wider than the volume grows the voxel edge with a warning,
    to the reference's placement."""
    a, _ = _scan(0.0, 6)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        vt = ttsdf.fuse_tsdf([scan_cloud_from_numpy(*a)], tmake_camera(**CAM),
                             [torch.eye(3)], [torch.zeros(3)], size_vox=(8, 8, 8), voxel=2.0)
        assert any("growing voxel" in str(w.message) for w in rec)
        vj = jtsdf.fuse_tsdf([_jax_cloud(a)], jmake_camera(**CAM), [jnp.eye(3)],
                             [jnp.zeros(3)], size_vox=(8, 8, 8), voxel=2.0)
    _volumes_close(vt, jax.tree.map(np.asarray, vj))
    p = a[0][a[1]]
    lo = _np(vt.origin)
    assert (p >= lo - 1e-3).all() and (p <= lo + 8 * float(vt.voxel) + 1e-3).all()


def test_extract_mesh_matches_reference(fused):
    """The reference's volume through the port's extraction: the same faces
    in the same order; and the port's own volume close to the reference's
    mesh."""
    _, vj, vt = fused
    jv, jf, jc = jtsdf.extract_mesh(jtsdf.TSDFVolume(*map(jnp.asarray, vj)),
                                    with_colors=True)
    tv, tf, tc = ttsdf.extract_mesh(ttsdf.volume_from_numpy(*vj), with_colors=True)
    assert jf.shape[0] > 200
    assert tf.dtype == torch.int32 and tuple(tf.shape) == jf.shape
    np.testing.assert_array_equal(_np(tf), jf)
    np.testing.assert_allclose(_np(tv), jv, atol=1e-4)
    np.testing.assert_allclose(_np(tc), jc, atol=1e-5)
    own_v, own_f = ttsdf.extract_mesh(vt)
    assert abs(own_f.shape[0] - jf.shape[0]) <= 0.01 * jf.shape[0]


def test_extract_mesh_empty_volume():
    v, f, c = ttsdf.extract_mesh(ttsdf.make_volume(np.zeros(3, np.float32),
                                                   size_vox=(4, 4, 4)), with_colors=True)
    assert tuple(v.shape) == (0, 3) and tuple(f.shape) == (0, 3) and tuple(c.shape) == (0,)


def test_mesh_winding_consistent():
    """The reference's winding test on the port: every face of an analytic
    sphere's tsdf winds outward (the 0b0111 case carries the reversed
    winding)."""
    vol = ttsdf.make_volume(CENTER - 80.0, size_vox=(80, 80, 80), voxel=2.0)
    c = ttsdf._voxel_centers(vol)
    d = torch.linalg.norm(c - torch.from_numpy(CENTER), dim=-1)
    tsdf = torch.clamp((d - 60.0) / vol.trunc, -1.0, 1.0)
    vol = vol._replace(tsdf=tsdf, weight=torch.ones_like(tsdf))
    verts, _ = ttsdf.extract_mesh(vol)
    tris = _np(verts).reshape(-1, 3, 3)
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    dots = np.sum(n * (tris.mean(axis=1) - CENTER), axis=-1)
    area2 = np.linalg.norm(n, axis=-1)
    good = area2 > 1e-9 * area2.max()
    assert float(np.mean(dots[good] > 0)) == 1.0


def _parse_obj(path):
    v, f = [], []
    for line in open(path):
        if line.startswith("v "):
            v.append([float(x) for x in line.split()[1:]])
        elif line.startswith("f "):
            f.append([int(x) for x in line.split()[1:]])
    return np.array(v), np.array(f)


@pytest.mark.parametrize("with_colors", [True, False])
def test_write_tsdf_mesh_obj_matches_reference(fused, tmp_path, with_colors):
    _, vj, _ = fused
    nj = jtsdf.write_tsdf_mesh_obj(tmp_path / "j.obj", jtsdf.TSDFVolume(*map(jnp.asarray, vj)),
                                   with_colors=with_colors)
    nt = ttsdf.write_tsdf_mesh_obj(tmp_path / "t.obj", ttsdf.volume_from_numpy(*vj),
                                   with_colors=with_colors)
    assert nt == nj
    (jv, jf), (tv, tf) = _parse_obj(tmp_path / "j.obj"), _parse_obj(tmp_path / "t.obj")
    assert tv.shape == jv.shape and tv.shape[1] == (6 if with_colors else 3)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, atol=2e-4)
    assert open(tmp_path / "t.obj").readline() == "# slr tsdf mesh export\n"


def test_grid_faces_and_write_mesh_obj_match_reference(tmp_path):
    a, _ = _scan(0.3, 7)
    pts, mask, col = a[0], a[1].copy(), a[2]
    mask[::7, ::5] = False                               # holes in the grid
    fj, vj = jmesh.grid_faces(jnp.asarray(pts), jnp.asarray(mask), max_edge=8.0)
    ft, vt = tmesh.grid_faces(torch.from_numpy(pts), torch.from_numpy(mask), max_edge=8.0)
    assert ft.dtype == torch.int32
    np.testing.assert_array_equal(_np(ft), np.asarray(fj))
    np.testing.assert_array_equal(_np(vt), np.asarray(vj))
    assert 0 < int(vt.sum()) < vt.numel()
    for colors in (None, col):
        nj = jmesh.write_mesh_obj(tmp_path / "j.obj", jnp.asarray(pts), jnp.asarray(mask),
                                  max_edge=8.0,
                                  colors=None if colors is None else jnp.asarray(colors))
        nt = tmesh.write_mesh_obj(tmp_path / "t.obj", torch.from_numpy(pts),
                                  torch.from_numpy(mask), max_edge=8.0,
                                  colors=None if colors is None else torch.from_numpy(colors))
        assert nt == nj
        assert open(tmp_path / "t.obj").read() == open(tmp_path / "j.obj").read()
