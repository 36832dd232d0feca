"""slr_torch's checks, observability, viewer, batch and stream against the
JAX reference (CPU), on a 256x128 spheres scene rendered by ``slr.synth``.

The checks give the reference's messages; the viewer's image equals JAX's
bit for bit (order-free scatters); the batch and the stream equal the
port's per-scan ``reconstruct_dense`` bit for bit (one call a scan).
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr.config import PatternConfig as JPatternConfig
from slr.pipeline import checks as jchecks
from slr.pipeline import viewer as jviewer
from slr.synth import spheres_scene
from slr.synth.render import default_rig, render_scan
from slr_torch import observability as obs
from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.dist import make_mesh
from slr_torch.dist.batch import batched_reconstruct
from slr_torch.geom.camera import camera_from_numpy
from slr_torch.pipeline import checked_reconstruct, nan_guard, reconstruct_stream
from slr_torch.pipeline import viewer as tviewer
from slr_torch.pipeline.checks import validate_cloud
from slr_torch.pipeline.reconstruct import reconstruct_dense, reconstruct_scan

torch.set_num_threads(2)

CAM_W, CAM_H = 256, 128
CFG = dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4)


@pytest.fixture(scope="module")
def scene():
    camj, projj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192,
                              baseline=150.0, toe_in_deg=14.0)
    scans = [np.array(render_scan(camj, projj, spheres_scene(camj, CAM_H, CAM_W),
                                  JPatternConfig(**CFG), noise_std=0.004,
                                  key=jax.random.PRNGKey(k)).frames) for k in range(3)]
    return (camj, projj, camera_from_numpy(jax.tree.map(np.asarray, camj)),
            camera_from_numpy(jax.tree.map(np.asarray, projj)), scans)


def _bits_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------------------------ checks

@pytest.mark.parametrize("fused", [True, False])
def test_checked_reconstruct_ok_and_fail(scene, fused):
    camj, projj, cam, proj, scans = scene
    cfg = PatternConfig(**CFG)
    err, cloud = checked_reconstruct(torch.from_numpy(scans[0]), cam, proj, cfg, fused=fused)
    assert err.get() is None
    err.throw()
    route = reconstruct_dense if fused else reconstruct_scan
    _bits_equal(cloud, route(torch.from_numpy(scans[0]), cam, proj, cfg))
    # all-black frames: an empty mask, the reference's located message
    zeros = np.zeros_like(scans[0])
    err2, _ = checked_reconstruct(torch.from_numpy(zeros), cam, proj, cfg, fused=fused)
    errj, _ = jchecks.checked_reconstruct(jnp.asarray(zeros), camj, projj,
                                          JPatternConfig(**CFG), fused=fused)
    assert "mask nearly empty" in err2.get() and "mask nearly empty" in str(errj.get())
    with pytest.raises(RuntimeError, match="mask nearly empty"):
        err2.throw()


def test_validate_cloud_finds_non_finite_points(scene):
    _, _, cam, proj, scans = scene
    cloud = reconstruct_dense(torch.from_numpy(scans[0]), cam, proj, PatternConfig(**CFG))
    assert validate_cloud(cloud).get() is None
    pts = cloud.points.clone()
    r, c = cloud.mask.nonzero()[0].tolist()
    pts[r, c] = float("inf")
    assert validate_cloud(cloud._replace(points=pts)).get() == \
        "non-finite points in masked region"
    # a non-finite point outside the mask is not the cloud's
    pts = cloud.points.clone()
    r, c = (~cloud.mask).nonzero()[0].tolist()
    pts[r, c] = float("nan")
    assert validate_cloud(cloud._replace(points=pts)).get() is None
    assert "mask nearly empty" in validate_cloud(cloud, min_valid_fraction=0.99).get()


def test_nan_guard_catches_a_produced_nan_and_restores():
    x = torch.tensor(-1.0)
    with nan_guard():
        with pytest.raises(FloatingPointError):
            torch.log(x)
        # a NaN that enters as an input does not count
        y = torch.tensor([float("nan"), 1.0])
        assert torch.isnan((y * 2)[0])
        # an in-place op writing a NaN does
        with pytest.raises(FloatingPointError):
            torch.tensor([-1.0]).sqrt_()
        # allocations are not results
        torch.empty(1000)
    # restored: the same computation is silent outside
    assert bool(torch.isnan(torch.log(x)))


# ----------------------------------------------------------- observability

def test_observability(capsys):
    before = [r.id for r in obs.snapshot().spans if r.name == "aux.mul"]
    x = torch.ones((64, 64))
    with obs.span("aux.mul") as sp:
        y = x * 2
    rec = [r for r in obs.snapshot().spans if r.id == sp.id][0]
    assert rec.name == "aux.mul" and rec.end_ns >= rec.start_ns and not rec.wait
    took = [r for r in obs.snapshot().spans if r.name == "aux.mul" and r.id not in before]
    assert len(took) == 1 and took[0].end_ns - took[0].start_ns == rec.end_ns - rec.start_ns
    assert bool((y == 2).all())
    obs.log_event("stage", name="aux.mul", ms=(rec.end_ns - rec.start_ns) / 1e6)
    rec = json.loads(capsys.readouterr().err.splitlines()[-1])
    assert rec["event"] == "stage" and rec["name"] == "aux.mul"
    r = obs.roofline(bytes_accessed=1e9, flops=1e9, measured_ms=2.0)
    assert r["bound"] == "memory"
    assert 0 < r["sol_fraction"] <= 1.0
    # the H100 data sheet's 3.35 TB/s: 1 GB takes 0.2985 ms at its bound
    assert abs(r["sol_ms"] - 1e9 / 3.35e12 * 1e3) < 1e-9
    assert obs.roofline(1e6, 1e12, 100.0)["bound"] == "compute"
    ms = obs.time_fn(lambda a: a + 1, x, iters=3)
    assert ms >= 0.0
    buf = io.StringIO()
    obs.log_event("e", stream=buf, k=1)
    assert json.loads(buf.getvalue())["k"] == 1 and obs.is_host0()


def test_trace_writes_a_chrome_trace(tmp_path):
    with obs.trace(str(tmp_path / "tr")) as d:
        torch.ones(8) + 1
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert d == str(tmp_path / "tr") and "traceEvents" in data


# ------------------------------------------------------------------ viewer

def _planes():
    g = np.linspace(-1, 1, 40)
    xx, yy = np.meshgrid(g, g)
    near = np.stack([xx, yy, np.zeros_like(xx)], -1).reshape(-1, 3)
    far = np.stack([xx, yy, np.ones_like(xx)], -1).reshape(-1, 3)
    pts = np.concatenate([near, far]).astype(np.float32)
    col = np.concatenate([np.tile([1.0, 0.0, 0.0], (near.shape[0], 1)),
                          np.tile([0.0, 0.0, 1.0], (far.shape[0], 1))]).astype(np.float32)
    return pts, col


def test_viewer_occlusion_equals_reference(tmp_path):
    pts, col = _planes()
    img = tviewer.render_cloud_image(pts, col, azimuth=0.0, size=128, splat=2)
    ref = np.asarray(jviewer.render_cloud_image(pts, col, azimuth=0.0, size=128, splat=2))
    np.testing.assert_array_equal(img.numpy(), ref)
    assert (img.sum(-1) > 0).float().mean() > 0.05
    # the near (red) plane wins the z-buffer
    assert img[..., 0].sum() > 5.0 * img[..., 2].sum()
    outs = tviewer.render_turntable(pts, col, tmp_path / "tt", frames=2, size=64)
    refs = jviewer.render_turntable(pts, col, tmp_path / "ref", frames=2, size=64)
    assert len(outs) == 2
    for a, b in zip(outs, refs):
        assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("splat,size,uint8", [(0, 96, False), (1, 160, True), (2, 64, False)])
def test_viewer_cloud_equals_reference(scene, splat, size, uint8):
    _, _, cam, proj, scans = scene
    cloud = reconstruct_dense(torch.from_numpy(scans[0]), cam, proj, PatternConfig(**CFG))
    pts = cloud.points[cloud.mask]
    col = cloud.colors[cloud.mask]
    if uint8:
        col = (col[:, None].expand(-1, 3) * 255).to(torch.uint8)
    for az in (0.0, 0.6, 2.5):
        a = tviewer.render_cloud_image(pts, col, azimuth=az, size=size, splat=splat)
        b = jviewer.render_cloud_image(pts.numpy(), col.numpy(), azimuth=az, size=size,
                                       splat=splat)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # splat_points itself, with a view that leaves points behind it
    R = torch.eye(3)
    t = torch.tensor([0.0, 0.0, -480.0])
    c3 = torch.rand(pts.shape[0], 3, generator=torch.Generator().manual_seed(0))
    img, d = tviewer.splat_points(pts, c3, R, t, size=size, splat=splat)
    ij, dj = jviewer.splat_points(jnp.asarray(pts.numpy()), jnp.asarray(c3.numpy()),
                                  jnp.asarray(R.numpy()), jnp.asarray(t.numpy()),
                                  size=size, splat=splat)
    np.testing.assert_array_equal(img.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(d.numpy(), np.asarray(dj))


def test_write_image_without_cv2_writes_ppm(tmp_path, monkeypatch):
    import builtins

    real = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == "cv2":
            raise ImportError("no cv2")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    img = torch.rand(5, 7, 3, generator=torch.Generator().manual_seed(1))
    out = tviewer.write_image(tmp_path / "x", img)
    ref = jviewer.write_image(tmp_path / "y", img.numpy())
    assert out.endswith(".ppm") and ref.endswith(".ppm")
    assert open(out, "rb").read() == open(ref, "rb").read()


# ------------------------------------------------------------ batch, stream

@pytest.mark.parametrize("fused", [True, False])
def test_batched_reconstruct_equals_per_scan(scene, fused):
    _, _, cam, proj, scans = scene
    cfg = PatternConfig(**CFG)
    batch = torch.from_numpy(np.stack(scans))
    clouds = batched_reconstruct(batch, cam, proj, cfg, fused=fused)
    assert tuple(clouds.points.shape) == (3, CAM_H, CAM_W, 3)
    route = reconstruct_dense if fused else reconstruct_scan
    for i in range(3):
        _bits_equal([x[i] for x in clouds], route(batch[i], cam, proj, cfg))
    # a mesh of one rank (no process group) splits nothing: the same bits
    for a, b in zip(batched_reconstruct(batch, cam, proj, cfg, mesh=make_mesh(), fused=fused),
                    clouds):
        assert torch.equal(a, b)


@pytest.mark.parametrize("prefetch", [1, 2, 3])
@pytest.mark.parametrize("spatial_iters", [0, 4])
def test_stream_equals_sequential(scene, prefetch, spatial_iters):
    _, _, cam, proj, scans = scene
    cfg, dec = PatternConfig(**CFG), DecodeConfig()
    stacks = [scans[0], torch.from_numpy(scans[1]), np.round(scans[2] * 255).astype(np.uint8)]
    got = list(reconstruct_stream(iter(stacks), cam, proj, cfg, dec, prefetch=prefetch,
                                  spatial_iters=spatial_iters, device="cpu"))
    assert len(got) == 3
    for s, c in zip(stacks, got):
        s = torch.as_tensor(s)
        _bits_equal(c, reconstruct_dense(s, cam, proj, cfg, dec, spatial_iters=spatial_iters))


def test_stream_refuses_bad_prefetch_and_defaults_to_the_card(scene, monkeypatch):
    _, _, cam, proj, scans = scene
    with pytest.raises(ValueError):
        next(reconstruct_stream(scans, cam, proj, PatternConfig(**CFG), prefetch=0,
                                device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(reconstruct_stream(scans, cam, proj, PatternConfig(**CFG)))
