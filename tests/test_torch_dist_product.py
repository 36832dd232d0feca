"""The product routes of slr_torch on a world of ranks (CPU, Gloo):
``register_scans_batched`` and ``ba_refine`` with a mesh, the ``Session``
with a ``DistConfig``, and the CLI's multi-process options.

Ranks are subprocesses (``tests/test_torch_mp_worker.py``, and the CLI
itself), of one torch thread each, joined through a file store. The scenes
are the port's own renders (the rocks orbit of config 4 at 160x128, numpy
from torch seeds): these routes are held to the port's unsharded results,
which tests/test_torch_registerfuse.py and tests/test_torch_session.py hold
to JAX. Tolerances: clouds bit for bit (each scan is the single call's);
poses within the batched registration's bounds of
tests/test_torch_registerfuse.py, 1e-4 rad and 2e-2 mm (an edge aligned in
a smaller batch, and the BA's sums split over blocks, round differently).
"""

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import slr_torch.config as tcfg
import slr_torch.pipeline.registerfuse as treg
from slr_torch.geom.camera import Camera
from slr_torch.geom.se3 import so3_exp
from slr_torch.kernels.fused_scan import fused_decode_triangulate
from slr_torch.pipeline import Session
from slr_torch.pipeline.reconstruct import ScanCloud, reconstruct_scan
from slr_torch.synth.render import default_rig, move_rig, render_scan
from slr_torch.synth.scene import rocks_scene
from test_torch_mp_worker import REPO, run_world

torch.set_num_threads(2)

CAM_W, CAM_H = 160, 128
PATTERN = dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4)
RC = dict(icp_sample_points=1024, ransac_iters=64, icp_iters=10, pg_iters=10)
SCANS = 4
LANDMARKS = 128


@contextlib.contextmanager
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close_poses(a, b):
    np.testing.assert_allclose(_np(a.R), _np(b.R), atol=1e-4)
    np.testing.assert_allclose(_np(a.t), _np(b.t), atol=2e-2)


@pytest.fixture(scope="module")
def orbit():
    """SCANS noisy scans of the rocks scene from the config-4 orbit, their
    frames and the port's clouds of them."""
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0)
    cfg = tcfg.PatternConfig(**PATTERN)
    frames, clouds = [], []
    for s in range(SCANS):
        R_m = so3_exp(torch.tensor([0.0, 0.025 * s, 0.008 * s]))
        t_m = torch.tensor([7.0 * s, -3.0 * s, 0.0])
        c2, p2 = move_rig(cam, proj, R_m, t_m)
        scan = render_scan(c2, p2, rocks_scene(c2, CAM_H, CAM_W), cfg, noise_std=0.003,
                           generator=torch.Generator().manual_seed(40 + s))
        frames.append(scan.frames)
        with one_thread():
            clouds.append(reconstruct_scan(scan.frames, cam, proj, cfg))
    return cam, proj, frames, clouds


def _cams(cam, proj):
    return {f"{p}_{f}": _np(x) for p, c in (("cam", cam), ("proj", proj))
            for f, x in zip(Camera._fields, c)}


def _session(root, orbit, **dist):
    cam, proj, frames, _ = orbit
    s = Session(root, tcfg.ScanConfig(pattern=tcfg.PatternConfig(**PATTERN),
                                      registration=tcfg.RegistrationConfig(**RC),
                                      dist=tcfg.DistConfig(**dist),
                                      cam_width=CAM_W, cam_height=CAM_H), device="cpu")
    s.set_calibration(cam, proj, {"source": "default_rig"})
    for f in frames:
        s.add_scan(f)
    return s


@pytest.fixture(scope="module")
def world2(orbit, tmp_path_factory):
    """A 2-rank world: the registration routes over 2 map blocks, and a
    session laid out as 2 map blocks."""
    cam, proj, frames, clouds = orbit
    wd = tmp_path_factory.mktemp("world2")
    _session(wd / "session", orbit, map_blocks=2)
    inputs = dict(n_clouds=np.asarray(len(clouds)), **_cams(cam, proj))
    for s, c in enumerate(clouds):
        inputs.update({f"c{s}_{f}": _np(x) for f, x in zip(ScanCloud._fields, c)})
    np.savez(wd / "inputs.npz", **inputs)
    (wd / "params.json").write_text(json.dumps(dict(
        reg_blocks=2, reg=RC, landmarks=LANDMARKS, session=str(wd / "session"),
        add_root=str(wd / "added"))))
    return wd, run_world(2, wd, ["register", "session", "add_scan"])


def test_register_scans_batched_over_map_blocks(orbit, world2):
    """Each rank aligns its half of a round's edges; the gathered round is
    the same bits on both ranks, within the batched bounds of the unsharded
    call; one gather a round (chain, closures, the closures' race)."""
    cam, _, _, clouds = orbit
    with one_thread():
        ref = treg.register_scans_batched(clouds, tcfg.RegistrationConfig(**RC),
                                          use_features=True, cam=cam)
    _, results = world2
    for r in results:
        got = treg.RegisteredScans(*r["register"]["reg"])
        assert all(torch.equal(a, b) for a, b in zip(got, results[0]["register"]["reg"]))
        _close_poses(got, ref)
        np.testing.assert_allclose(_np(got.icp_rms), _np(ref.icp_rms), atol=1e-3)
        assert r["register"]["gathers"] == 3


def test_ba_refine_over_map_blocks(orbit, world2):
    """The distributed BA under ``ba_refine``: 2 rounds of 2 iterations,
    one all-reduce an iteration, against the single-device refinement of
    the same registration."""
    _, _, _, clouds = orbit
    _, results = world2
    reg = treg.RegisteredScans(*results[0]["register"]["reg"])
    with one_thread():
        ref = treg.ba_refine(clouds, reg, n_landmarks=LANDMARKS, iters=4)
    for r in results:
        got = treg.RegisteredScans(*r["register"]["ba"])
        assert all(torch.equal(a, b) for a, b in zip(got, results[0]["register"]["ba"]))
        _close_poses(got, ref)
        np.testing.assert_allclose(float(got.pg_rms), float(ref.pg_rms), rtol=1e-3)
        assert r["register"]["ba_all_reduce"] == 4


def test_session_over_two_ranks_equals_one(orbit, world2, tmp_path):
    """A session with 2 map blocks in a 2-rank world: the clouds are the
    single-rank session's bits (the batch split over the blocks), the poses
    within the batched bounds; every rank returns the same; only rank 0
    writes (the clouds and the registration)."""
    wd, results = world2
    single = tmp_path / "single"
    shutil.copytree(wd / "session", single, ignore=shutil.ignore_patterns("clouds"))
    s = Session(single, device="cpu")
    assert s.mesh is None      # a world of one: the fallback
    with one_thread():
        n = s.reconstruct_all()
        reg = s.register(use_features=True)
    for r in results:
        out = r["session"]
        assert out["mesh"] == {"map_block": 2, "pixel_tile": 1}
        assert len(out["clouds"]) == n == SCANS
        for i in range(n):
            assert all(torch.equal(a, b) for a, b in zip(out["clouds"][i], s.load_cloud(i)))
        _close_poses(treg.RegisteredScans(*out["reg"]), reg)
    assert all(torch.equal(a, b) for a, b in zip(results[0]["session"]["reg"],
                                                 results[1]["session"]["reg"]))
    assert results[1]["session"]["writes"] == []
    written = sorted(os.path.basename(p) for p in results[0]["session"]["writes"])
    assert written == ["registration.npz"] + [f"scan_{i:03d}.npz" for i in range(SCANS)]
    assert s.load_registration().R.shape == (SCANS, 3, 3)
    on_disk = Session(wd / "session", device="cpu").load_registration()
    assert torch.equal(on_disk.R, results[0]["session"]["reg"][0])


def test_add_scan_returns_one_index_on_every_rank(world2):
    """Rank 1 reaches each ``add_scan`` half a second after rank 0: both
    count the scans on disk before rank 0 writes, so both return the same
    index, and every scan is written once."""
    _, results = world2
    for r in results:
        assert r["add_scan"] == dict(indices=[0, 1, 2], scans=3)


def test_cli_across_processes_takes_the_pixel_tile_route(orbit, tmp_path):
    """``--coordinator/--num-procs/--proc-id`` on two CPU ranks, the
    session laid out as 2 pixel tiles: ``reconstruct`` takes
    ``sharded_reconstruct`` (K1's plain version a rank at its row offset),
    and the cloud rank 0 writes is the unsharded K1 call's bits."""
    cam, proj, frames, _ = orbit
    root = tmp_path / "s"
    _session(root, orbit, pixel_tiles=2)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    store = f"file://{tmp_path / 'store'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "slr_torch.cli", "--device", "cpu", "--coordinator", store,
         "--num-procs", "2", "--proc-id", str(r), "reconstruct", "--session", str(root),
         "--index", "1"], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        cwd=REPO) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all("valid points" in o for o in outs), outs
    with one_thread():
        ref = fused_decode_triangulate(frames[1], cam, proj, tcfg.PatternConfig(**PATTERN),
                                       tcfg.DecodeConfig())
    cloud = Session(root, device="cpu").load_cloud(1)
    assert torch.equal(cloud.points, ref.points.movedim(0, -1))
    assert torch.equal(cloud.mask, ref.mask > 0.5)
    assert torch.equal(cloud.x_p, ref.x_p) and torch.equal(cloud.quality, ref.quality)
    assert torch.equal(cloud.colors, frames[1][0])


def test_session_mesh_builds_from_a_world_of_its_layout(orbit, tmp_path, capsys):
    """Without a process group the world is one rank: a layout of 2 falls
    back (``mesh_fallback`` with ``available`` 1) and a layout of 1 is no
    mesh at all."""
    s = _session(tmp_path / "a", orbit, pixel_tiles=2)
    capsys.readouterr()
    assert s.mesh is None
    events = [json.loads(line) for line in capsys.readouterr().err.splitlines()]
    assert events == [dict(events[0], event="mesh_fallback", requested=2, available=1)]
    s1 = Session(tmp_path / "b", dataclasses.replace(s.config, dist=tcfg.DistConfig()),
                 device="cpu")
    assert s1.mesh is None
