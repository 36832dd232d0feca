"""slr_torch.io against slr.io (CPU): the same numpy arrays through both.

PLY, OBJ and calibration JSON files are held to the reference's bytes;
the OpenCV YAML, PGM and scan folders round trip and cross between the
packages; ``peek_stage`` and the BA checkpoint read the same. The native
PLY library is built by g++ from the port's own ``plyio.cpp``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import slr.io as jio
import slr_torch.io as tio
from slr.geom.camera import make_camera as jmake_camera
from slr.geom.se3 import so3_exp as jso3_exp
from slr_torch.config import ScanConfig as TScanConfig
from slr_torch.geom.camera import make_camera
from slr_torch.io import ply as tply

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cloud(n=500, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    col = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return pts, col, nrm


# ------------------------------------------------------------------- PLY

@pytest.mark.parametrize("colors", ["none", "uint8", "float01", "float255"])
@pytest.mark.parametrize("normals", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_ply_bytes_match_numpy_and_reference(tmp_path, colors, normals, masked):
    pts, col8, nrm = _cloud(seed=3)
    rng = np.random.default_rng(4)
    col = {"none": None, "uint8": col8,
           "float01": rng.uniform(0, 1, (500, 3)).astype(np.float32),
           "float255": rng.uniform(0, 300, (500, 3)).astype(np.float32)}[colors]
    nrm = nrm if normals else None
    mask = rng.random(500) > 0.3 if masked else None
    kw = dict(mask=mask, colors=col, normals=nrm)
    n_ref = jio.write_ply(tmp_path / "ref.ply", pts, **kw)
    n_np = tply.write_ply_numpy(tmp_path / "np.ply", pts, **kw)
    # tensors in, the native writer
    as_t = {k: None if v is None else torch.from_numpy(np.asarray(v)) for k, v in kw.items()}
    n_nat = tio.write_ply(tmp_path / "nat.ply", torch.from_numpy(pts), **as_t)
    assert n_ref == n_np == n_nat == (int(mask.sum()) if masked else 500)
    ref = (tmp_path / "ref.ply").read_bytes()
    assert (tmp_path / "np.ply").read_bytes() == ref
    assert (tmp_path / "nat.ply").read_bytes() == ref
    # both readers give what was written, and the reference's reader agrees
    got = tio.read_ply(tmp_path / "nat.ply")
    for a, b, c in zip(got, tply.read_ply_numpy(tmp_path / "nat.ply"),
                       jio.read_ply(tmp_path / "nat.ply")):
        assert (a is None) == (b is None) == (c is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    sel = mask if masked else slice(None)
    np.testing.assert_array_equal(got[0], pts[sel])
    if normals:
        np.testing.assert_array_equal(got[2], nrm[sel])
    if colors == "uint8":
        np.testing.assert_array_equal(got[1], col8[sel])


def test_ply_colour_rule_truncates():
    """Float colours at most 1 + 1e-6 are scaled by 255, then clipped and
    truncated to uint8, exactly as the reference."""
    col = np.array([[0.0, 0.5, 1.0], [1.0 + 5e-7, 0.999, 0.0041]], np.float32)
    pts = np.zeros((2, 3), np.float32)
    _, c, _ = tply._as_compact(pts, colors=col)
    np.testing.assert_array_equal(c, np.clip(col * 255.0, 0, 255).astype(np.uint8))
    _, c2, _ = tply._as_compact(pts, colors=col * 2)     # max > 1: no scaling
    np.testing.assert_array_equal(c2, (col * 2).astype(np.uint8))


def test_ply_grid_shape_and_mask(tmp_path):
    pts = torch.zeros((4, 5, 3))
    mask = torch.zeros((4, 5), dtype=torch.bool)
    mask[1, 2] = mask[3, 4] = True
    assert tio.write_ply(tmp_path / "m.ply", pts, mask=mask) == 2
    assert tio.read_ply(tmp_path / "m.ply")[0].shape == (2, 3)


def test_ply_write_failure_raises(tmp_path):
    with pytest.raises(OSError):
        tio.write_ply(tmp_path / "no_such_dir" / "x.ply", np.zeros((3, 3), np.float32))
    with pytest.raises(OSError):
        tio.read_ply(tmp_path / "missing.ply")


def test_native_ply_build_lands_in_the_port_build_dir():
    from slr_torch.kernels.build import BUILD_DIR

    path = tply.library()._name
    assert os.path.dirname(path) == str(BUILD_DIR)
    assert os.path.basename(path).startswith("libplyio_")


def test_native_ply_build_failure_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with g++'s log: no fall-back."""
    from slr_torch.kernels import build

    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
        build.build_host_library(bad)
    assert not list((tmp_path / "_build").glob("*"))


def test_ply_never_loads_the_reference_library(tmp_path):
    """In a fresh process, write and read a PLY through the port: the
    reference's slr/native/libslrio.so is never mapped, the port's build
    is."""
    code = (
        "import sys, numpy as np\n"
        "import slr_torch.io.ply as p\n"
        f"p.write_ply({str(tmp_path / 'a.ply')!r}, np.ones((4, 3), np.float32))\n"
        f"p.read_ply({str(tmp_path / 'a.ply')!r})\n"
        "maps = open('/proc/self/maps').read()\n"
        "bad = sorted(m for m in sys.modules if m == 'slr' or m.startswith('slr.'))\n"
        "print('libslrio' in maps, 'libplyio_' in maps, bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["False", "True", "[]"], proc.stdout


@pytest.mark.parametrize("colored", [False, True])
def test_obj_bytes_match_reference(tmp_path, colored):
    pts, col, _ = _cloud(40, seed=5)
    mask = np.random.default_rng(6).random(40) > 0.4
    kw = dict(mask=mask, colors=col if colored else None)
    n1 = jio.write_obj(tmp_path / "ref.obj", pts, **kw)
    n2 = tio.write_obj(tmp_path / "port.obj", torch.from_numpy(pts),
                       mask=torch.from_numpy(mask), colors=kw["colors"])
    assert n1 == n2 == int(mask.sum())
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "ref.obj").read_bytes()


# ------------------------------------------------------------ calibration

def _rig_numpy(seed=0):
    rng = np.random.default_rng(seed)
    Rc = np.asarray(jso3_exp(rng.uniform(-0.05, 0.05, 3).astype(np.float32)))
    Rp = np.asarray(jso3_exp(rng.uniform(-0.3, 0.3, 3).astype(np.float32)))
    cam = dict(fx=1100.123, fy=1090.5, cx=640.25, cy=511.75,
               dist=rng.normal(0, 0.05, 5).astype(np.float32), R=Rc,
               t=rng.normal(0, 3, 3).astype(np.float32))
    proj = dict(fx=1500.0, fy=1499.9, cx=512.1, cy=383.3,
                dist=rng.normal(0, 0.02, 5).astype(np.float32), R=Rp,
                t=np.array([-100.0, 5.0, 20.0], np.float32))
    return cam, proj


def _cams(d):
    return jmake_camera(**d), make_camera(**d)


def _same_camera(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y.detach().cpu().numpy(), np.asarray(x))


@pytest.mark.parametrize("with_cam2", [False, True])
def test_calibration_json_bytes_match_reference(tmp_path, with_cam2):
    cam, proj = _rig_numpy(1)
    (cj, ct), (pj, pt) = _cams(cam), _cams(proj)
    c2 = dict(cam, fx=1111.5, t=np.array([280.0, 0.0, 0.0], np.float32))
    c2j, c2t = _cams(c2) if with_cam2 else (None, None)
    meta = {"rms": 0.2142, "source": "test"}
    jio.save_calibration(tmp_path / "ref.json", cj, pj, meta, cam2=c2j)
    tio.save_calibration(tmp_path / "port.json", ct, pt, meta, cam2=c2t)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    # round trip, in the port and across packages
    out = tio.load_calibration(tmp_path / "ref.json", with_cam2=True, device="cpu")
    ref = jio.load_calibration(tmp_path / "port.json", with_cam2=True)
    for a, b in zip(ref[:2], out[:2]):
        _same_camera(a, b)
    assert out[2] == ref[2] == meta
    if with_cam2:
        _same_camera(ref[3], out[3])
    else:
        assert out[3] is None and ref[3] is None
    assert len(tio.load_calibration(tmp_path / "ref.json", device="cpu")) == 3


def test_load_calibration_defaults_to_the_card(tmp_path, monkeypatch):
    cam, proj = _rig_numpy(2)
    tio.save_calibration(tmp_path / "c.json", make_camera(**cam), make_camera(**proj))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.load_calibration(tmp_path / "c.json")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.load_calibration_opencv(tmp_path / "c.json")


# ----------------------------------------------------- OpenCV YAML interop

def test_opencv_yaml_roundtrip(tmp_path):
    K = np.array([[1100.0, 0, 640.0], [0, 1090.0, 512.0], [0, 0, 1.0]])
    d = np.array([[0.1, -0.05, 0.001, 0.002, 0.0]])
    nodes = {"camera_matrix": K, "dist": d, "image_width": 1280, "rms": 0.217,
             "note": "hello", "nested": {"a": 1, "b": [1.5, 2.0]}}
    tio.write_opencv_yaml(tmp_path / "port.yml", nodes)
    jio.write_opencv_yaml(tmp_path / "ref.yml", nodes)
    assert (tmp_path / "port.yml").read_bytes() == (tmp_path / "ref.yml").read_bytes()
    got = tio.read_opencv_yaml(tmp_path / "port.yml")
    np.testing.assert_allclose(got["camera_matrix"], K)
    np.testing.assert_allclose(got["dist"], d)
    assert got["image_width"] == 1280 and abs(got["rms"] - 0.217) < 1e-12
    assert got["note"] == "hello" and got["nested"] == {"a": 1, "b": [1.5, 2.0]}


def test_opencv_yaml_cv2_parity(tmp_path):
    """cv2 reads what the port writes; the port reads what cv2 writes."""
    cv2 = pytest.importorskip("cv2")
    K = np.array([[1234.5, 0, 639.5], [0, 1230.25, 511.5], [0, 0, 1.0]])
    ours = tmp_path / "ours.yml"
    tio.write_opencv_yaml(ours, {"camera_matrix": K, "n_views": 12})
    fs = cv2.FileStorage(str(ours), cv2.FILE_STORAGE_READ)
    np.testing.assert_allclose(fs.getNode("camera_matrix").mat(), K)
    assert int(fs.getNode("n_views").real()) == 12
    fs.release()
    theirs = tmp_path / "cv2.yml"
    fs = cv2.FileStorage(str(theirs), cv2.FILE_STORAGE_WRITE)
    fs.write("camera_matrix", K)
    fs.write("distortion_coefficients", np.array([[0.1, -0.2, 0.0, 0.0, 0.3]]))
    fs.write("image_width", 1280)
    fs.release()
    got = tio.read_opencv_yaml(theirs)
    np.testing.assert_allclose(got["camera_matrix"], K)
    np.testing.assert_allclose(got["distortion_coefficients"], [[0.1, -0.2, 0.0, 0.0, 0.3]])
    assert got["image_width"] == 1280


def test_opencv_calibration_crosses_packages(tmp_path):
    """A rig saved by either package loads in the other to the same
    cameras; the world poses survive the relative-pose encoding."""
    cam, proj = _rig_numpy(3)
    (cj, ct), (pj, pt) = _cams(cam), _cams(proj)
    tio.save_calibration_opencv(tmp_path / "port.yml", ct, pt, {"rms": 0.3, "n": 2})
    jio.save_calibration_opencv(tmp_path / "ref.yml", cj, pj, {"rms": 0.3, "n": 2})
    assert (tmp_path / "port.yml").read_bytes() == (tmp_path / "ref.yml").read_bytes()
    c2, p2, meta = tio.load_calibration_opencv(tmp_path / "ref.yml", device="cpu")
    c2j, p2j, metaj = jio.load_calibration_opencv(tmp_path / "port.yml")
    _same_camera(c2j, c2)
    _same_camera(p2j, p2)
    assert meta == metaj == {"rms": 0.3, "n": 2}
    np.testing.assert_allclose(c2.R.numpy(), cam["R"], atol=1e-6)
    np.testing.assert_allclose(p2.R.numpy(), proj["R"], atol=1e-5)
    np.testing.assert_allclose(p2.t.numpy(), proj["t"], atol=1e-4)
    np.testing.assert_allclose(c2.dist.numpy(), cam["dist"], atol=1e-6)


# ------------------------------------------------------------ scan folders

def test_pgm_roundtrip_16bit_and_cross_read(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 65536, (33, 47)).astype(np.uint16)
    tio.write_pgm(tmp_path / "a.pgm", torch.from_numpy(img.astype(np.int32)).to(torch.uint16))
    jio.write_pgm(tmp_path / "b.pgm", img)
    assert (tmp_path / "a.pgm").read_bytes() == (tmp_path / "b.pgm").read_bytes()
    np.testing.assert_array_equal(np.asarray(tio.read_pgm(tmp_path / "a.pgm"), np.uint16), img)
    img8 = rng.integers(0, 256, (5, 7)).astype(np.uint8)
    tio.write_pgm(tmp_path / "c.pgm", img8)
    np.testing.assert_array_equal(jio.read_pgm(tmp_path / "c.pgm"), img8)


def test_scan_folder_roundtrip_and_cross_read(tmp_path):
    rng = np.random.default_rng(4)
    frames = rng.uniform(0, 1, (6, 24, 32)).astype(np.float32)
    tio.save_scan_folder(tmp_path / "scan0", torch.from_numpy(frames), fmt="pgm")
    back = tio.load_scan_folder(tmp_path / "scan0")
    assert back.shape == (6, 24, 32) and back.dtype == np.float32
    np.testing.assert_allclose(back, frames, atol=1.0 / 65535)
    np.testing.assert_array_equal(jio.load_scan_folder(tmp_path / "scan0"), back)
    jio.save_scan_folder(tmp_path / "scan1", frames, fmt="pgm")
    np.testing.assert_array_equal(tio.load_scan_folder(tmp_path / "scan1"), back)


def test_scan_folder_png_cv2(tmp_path):
    pytest.importorskip("cv2")
    rng = np.random.default_rng(5)
    frames = rng.uniform(0, 1, (3, 16, 20)).astype(np.float32)
    tio.save_scan_folder(tmp_path / "scan1", frames, fmt="png")
    back = tio.load_scan_folder(tmp_path / "scan1")
    np.testing.assert_allclose(back, frames, atol=1.0 / 65535)
    np.testing.assert_array_equal(jio.load_scan_folder(tmp_path / "scan1"), back)


def test_scan_folder_rejects_mixed_shapes_and_empty(tmp_path):
    d = tmp_path / "bad"
    d.mkdir()
    tio.write_pgm(d / "frame_000.pgm", np.zeros((8, 8), np.uint8))
    tio.write_pgm(d / "frame_001.pgm", np.zeros((8, 9), np.uint8))
    with pytest.raises(ValueError):
        tio.load_scan_folder(d)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tio.load_scan_folder(tmp_path / "empty")


# ------------------------------------------------------------ checkpoints

def test_stage_from_tensors_and_peek_match_reference(tmp_path):
    arrays = dict(a=torch.arange(5), b=torch.ones((2, 2), dtype=torch.float64),
                  m=torch.zeros((3, 4, 5), dtype=torch.bool),
                  u=torch.zeros((2, 20, 8, 6), dtype=torch.uint8))
    tio.save_stage(tmp_path / "s.npz", **arrays)
    d = tio.load_stage(tmp_path / "s.npz")
    dj = jio.load_stage(tmp_path / "s.npz")
    for k, v in arrays.items():
        assert isinstance(d[k], np.ndarray) and d[k].dtype == v.numpy().dtype
        np.testing.assert_array_equal(d[k], v.numpy())
        np.testing.assert_array_equal(dj[k], d[k])
    shapes = tio.peek_stage(tmp_path / "s.npz")
    assert shapes == jio.peek_stage(tmp_path / "s.npz")
    assert shapes == {k: tuple(v.shape) for k, v in arrays.items()}


def test_ba_checkpoint_crosses_packages(tmp_path):
    R = torch.eye(3).expand(3, 3, 3)
    t = torch.arange(9, dtype=torch.float32).reshape(3, 3)
    X = torch.ones((10, 3))
    tio.save_ba_state(tmp_path / "ba.npz", R, t, X, iteration=4, cost=1.5)
    for load in (tio.load_ba_state, jio.load_ba_state):
        R2, t2, X2, it, cost = load(tmp_path / "ba.npz")
        assert it == 4 and cost == 1.5
        np.testing.assert_array_equal(R2, R.numpy())
        np.testing.assert_array_equal(t2, t.numpy())
        np.testing.assert_array_equal(X2, X.numpy())
    jio.save_ba_state(tmp_path / "ba_ref.npz", R.numpy(), t.numpy(), X.numpy(), 2, 0.5)
    assert tio.load_ba_state(tmp_path / "ba_ref.npz")[3:] == (2, 0.5)


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("ext", [".json", ".yaml"])
def test_config_file_bytes_match_and_cross_load(tmp_path, ext):
    import slr.config as jcfg
    import slr_torch.config as tcfg

    kw = dict(cam_width=256, cam_height=160)
    pat = dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4)
    cj = jcfg.ScanConfig(pattern=jcfg.PatternConfig(**pat),
                         reconstruct=jcfg.ReconstructConfig(checked=True, sor_k=6),
                         dist=jcfg.DistConfig(pixel_tiles=2), **kw)
    ct = tcfg.ScanConfig(pattern=tcfg.PatternConfig(**pat),
                         reconstruct=tcfg.ReconstructConfig(checked=True, sor_k=6),
                         dist=tcfg.DistConfig(pixel_tiles=2), **kw)
    jcfg.save_config(cj, tmp_path / f"ref{ext}")
    tcfg.save_config(ct, tmp_path / f"port{ext}")
    assert (tmp_path / f"port{ext}").read_bytes() == (tmp_path / f"ref{ext}").read_bytes()
    assert tcfg.load_config(tmp_path / f"ref{ext}") == ct
    assert jcfg.load_config(tmp_path / f"port{ext}") == cj
    assert tcfg.load_config(tmp_path / f"port{ext}") == ct
    assert isinstance(TScanConfig().dist, tcfg.DistConfig)


@pytest.mark.parametrize("name", ["DistConfig", "ScanConfig"])
def test_session_config_fields_match_reference(name):
    import dataclasses

    import slr.config as jcfg
    import slr_torch.config as tcfg

    a, b = getattr(jcfg, name), getattr(tcfg, name)

    def spec(cls):
        return [(f.name, f.default, getattr(f.default_factory, "__name__", None))
                for f in dataclasses.fields(cls)]

    assert spec(a) == spec(b)
    assert a.__dataclass_params__.frozen and b.__dataclass_params__.frozen
    assert dataclasses.asdict(a()) == dataclasses.asdict(b())
