"""slr_torch.dist (the parallel tier over ``torch.distributed``) against the
JAX reference (CPU).

The port's ranks are subprocesses joined by Gloo through a file store
(``tests/test_torch_mp_worker.py``), in worlds of 1, 2 and 4 ranks of one
thread each; JAX runs in this process on conftest's 8-device CPU mesh, its
Pallas kernels in interpret mode. Both packages get the same numpy inputs,
made from seeds.

What is held, and how tightly:
- the halo rows and the sharded unwrap: bit for bit against the port's
  unsharded sweep and JAX's halo; the unwrap within 1e-5 rad of JAX's
  ``sharded_unwrap`` (the voting sweep's bound, tests/test_torch_unwrap.py);
- ``sharded_reconstruct``: bit for bit against the port's unsharded
  composition (K1's plain version, the sweep, ``triangulate_plane``); against
  JAX's ``sharded_reconstruct`` within K1's bounds of
  tests/test_torch_fused_scan.py (JAX's kernel takes a polynomial atan2:
  masks within 1e-3 of pixels, x_p within 1e-3 px on all but 1e-4 of them,
  points within 1e-2 mm where x_p agrees), while JAX's sharded result is
  within test_dist.py's 1e-5 of its own unsharded kernel;
- the distributed BA: the same bits on every rank, one all-reduce an
  iteration, and test_dist.py's bounds (t 1e-3, R 1e-5, X 1e-3, rms 1e-3
  relative) against the port's single-device BA and JAX's distributed BA;
- the batch over map blocks: every scan the single call's bits.
The oracles of the port are computed here on one torch thread, as the
ranks run, so that both take the same vectorised loops.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from slr import observability as jobs
from slr.config import DecodeConfig as JDecodeConfig
from slr.config import PatternConfig as JPatternConfig
from slr.dist import distributed_bundle_adjust as jax_dist_ba
from slr.dist import halo_exchange_rows as jax_halo
from slr.dist import make_mesh as jax_make_mesh
from slr.dist import resume_ba as jax_resume_ba
from slr.dist import sharded_reconstruct as jax_sharded_reconstruct
from slr.dist import sharded_unwrap as jax_sharded_unwrap
from slr.geom.se3 import so3_exp
from slr.io import save_ba_state as jax_save_ba_state
from slr.kernels import fused_decode_triangulate as jax_fused
from slr.synth import bumps_depth
from slr.synth.render import default_rig, render_scan
from slr_torch import observability as tobs
from slr_torch.codec.unwrap import TWO_PI, spatial_quality_unwrap
from slr_torch.config import DecodeConfig, PatternConfig
from slr_torch.dist import (bundle_adjust_reference, comm, halo_exchange_rows,
                            init_distributed, make_mesh, reshard_fragments)
from slr_torch.geom.camera import Camera, camera_from_numpy
from slr_torch.geom.triangulate import triangulate_plane
from slr_torch.kernels.fused_scan import fused_decode_triangulate
from slr_torch.pipeline.reconstruct import reconstruct_dense, reconstruct_scan
from test_torch_mp_worker import run_world

torch.set_num_threads(2)

CAM_W, CAM_H = 256, 128
CFG = dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4)
SPATIAL = [0, 4]
EXCHANGE = [1, 3, 8]
BA_ITERS = 8
HUBER = 1.0
BATCH_BLOCKS = 2


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


def _unwrap_problem():
    """tests/test_dist.py's halo-fusion map: a 64x128 ramp with noise, 60
    isolated pixels two fringe orders off."""
    rng = np.random.default_rng(5)
    H, W = 64, 128
    Phi = np.linspace(0, 40, W)[None, :] + 0.05 * rng.normal(size=(H, W))
    bad = np.zeros((H, W), bool)
    bad[rng.integers(1, H - 1, 60), rng.integers(1, W - 1, 60)] = True
    Phi_n = np.where(bad, Phi + 2 * np.pi * 2, Phi).astype(np.float32)
    return Phi_n, np.where(bad, 0.05, 1.0).astype(np.float32), np.ones((H, W), bool)


def _ba_problem(S=4, L=64, K=3, noise=0.01, seed=0):
    """tests/test_dist.py's ``_make_ba_problem`` in numpy (rotations by the
    reference's so3_exp), with unit normals for plane rows."""
    rng = np.random.default_rng(seed)
    R_true = [np.eye(3, dtype=np.float32)]
    t_true = [np.zeros(3, np.float32)]
    for _ in range(1, S):
        R_true.append(np.asarray(so3_exp(jnp.asarray(rng.uniform(-0.3, 0.3, 3),
                                                     jnp.float32))))
        t_true.append(rng.uniform(-50, 50, 3).astype(np.float32))
    R_true, t_true = np.stack(R_true), np.stack(t_true)
    X_true = rng.uniform(-100, 100, (L, 3)).astype(np.float32)
    obs_s = rng.integers(0, S, (L, K)).astype(np.int32)
    p = np.einsum("lkij,lki->lkj", R_true[obs_s], X_true[:, None, :] - t_true[obs_s])
    p = (p + rng.normal(0, noise, p.shape)).astype(np.float32)
    R0 = np.stack([R_true[s] @ np.asarray(so3_exp(jnp.asarray(rng.normal(0, 0.02, 3),
                                                              jnp.float32)))
                   for s in range(S)]).astype(np.float32)
    t0 = (t_true + rng.normal(0, 1.0, (S, 3))).astype(np.float32)
    X0 = (X_true + rng.normal(0, 1.0, (L, 3))).astype(np.float32)
    R0[0], t0[0] = np.eye(3), 0.0
    n = rng.normal(size=(L, K, 3))
    obs_n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    return (R_true, t_true), dict(ba_R0=R0, ba_t0=t0, ba_X0=X0, ba_s=obs_s, ba_p=p,
                                  ba_w=np.ones((L, K), np.float32), ba_n=obs_n)


def _recovery_problem():
    """tests/test_aux.py's elastic-recovery case (seed 3), the last eighth
    of the landmarks lost."""
    rng = np.random.default_rng(3)
    S, L, K = 4, 64, 3
    R_true = [np.eye(3, dtype=np.float32)]
    t_true = [np.zeros(3, np.float32)]
    for _ in range(1, S):
        R_true.append(np.asarray(so3_exp(jnp.asarray(rng.uniform(-0.2, 0.2, 3),
                                                     jnp.float32))))
        t_true.append(rng.uniform(-30, 30, 3).astype(np.float32))
    R_true, t_true = np.stack(R_true), np.stack(t_true)
    X = rng.uniform(-80, 80, (L, 3)).astype(np.float32)
    obs_s = rng.integers(0, S, (L, K)).astype(np.int32)
    p = np.einsum("lkij,lki->lkj", R_true[obs_s], X[:, None, :] - t_true[obs_s])
    t0 = t_true + rng.normal(0, 0.5, (S, 3)).astype(np.float32)
    t0[0] = 0.0
    keep = np.ones(L, bool)
    keep[L // 8 * 7:] = False
    return t_true, dict(rc_R=R_true, rc_t0=t0.astype(np.float32),
                        rc_X0=(X + 0.5).astype(np.float32), rc_s=obs_s,
                        rc_p=p.astype(np.float32), rc_w=np.ones((L, K), np.float32),
                        rc_keep=keep)


@pytest.fixture(scope="module")
def scene():
    cam, proj = default_rig(cam_w=CAM_W, cam_h=CAM_H, proj_w=256, proj_h=192,
                            baseline=150.0, toe_in_deg=14.0)
    frames = np.asarray(render_scan(cam, proj, bumps_depth(CAM_H, CAM_W, base=480.0,
                                                           amp=20.0),
                                    JPatternConfig(**CFG)).frames)
    cam_np, proj_np = (jax.tree.map(np.asarray, c) for c in (cam, proj))
    cams = {f"{p}_{f}": np.asarray(x, np.float32)
            for p, c in (("cam", cam_np), ("proj", proj_np))
            for f, x in zip(Camera._fields, c)}
    return cam, proj, frames, camera_from_numpy(cam_np), camera_from_numpy(proj_np), cams


def _world(n, tmp_path_factory, cases, inputs, **params):
    wd = tmp_path_factory.mktemp(f"world{n}")
    np.savez(wd / "inputs.npz", **inputs)
    (wd / "params.json").write_text(json.dumps(dict(
        pattern=CFG, spatial_iters=SPATIAL, exchange_every=EXCHANGE, unwrap_iters=8,
        ba_iters=BA_ITERS, huber=HUBER, batch_blocks=BATCH_BLOCKS, **params)))
    return run_world(n, wd, cases)


@pytest.fixture(scope="module")
def inputs(scene):
    _, _, frames, _, _, cams = scene
    Phi, q, mask = _unwrap_problem()
    _, ba = _ba_problem()
    _, rc = _recovery_problem()
    batch = np.stack([frames, frames[:, ::-1].copy(), frames[:, :, ::-1].copy(), frames])
    return dict(frames=frames, halo_x=np.arange(16 * 8, dtype=np.float32).reshape(16, 8),
                uw_phi=Phi, uw_q=q, uw_mask=mask, batch=batch, **cams, **ba, **rc)


@pytest.fixture(scope="module")
def world4(inputs, tmp_path_factory):
    return _world(4, tmp_path_factory, ["mesh", "halo", "unwrap", "reconstruct", "ba",
                                        "recovery", "batch"], inputs, unwrap_tiles=2)


@pytest.fixture(scope="module")
def world2(inputs, tmp_path_factory):
    return _world(2, tmp_path_factory, ["mesh", "reconstruct", "ba"], inputs, unwrap_tiles=2)


@pytest.fixture(scope="module")
def world1(inputs, tmp_path_factory):
    return _world(1, tmp_path_factory, ["reconstruct", "ba"], inputs, unwrap_tiles=1)


def _same_on_every_rank(results, case):
    def flat(x):
        if torch.is_tensor(x):
            return [x]
        if isinstance(x, dict):
            return [t for k in sorted(x, key=str) for t in flat(x[k])]
        if isinstance(x, (tuple, list)):
            return [t for v in x for t in flat(v)]
        return [torch.tensor(x)] if isinstance(x, (int, float)) else []

    first = flat(results[0][case])
    for r in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(first, flat(r[case]), strict=True))


# --- communicated bytes, mesh, halo --------------------------------------------


@pytest.mark.parametrize("shape", [(1280, 4, 4, 3, 2), (256, 1, 4, 1, 1), (96, 8, 2, 2, 5)])
def test_comm_bytes_helpers_match_reference(shape):
    width, halo, dtype_bytes, n_arrays, iters = shape
    assert (tobs.comm_halo_bytes(width, halo, dtype_bytes, n_arrays, iters)
            == jobs.comm_halo_bytes(width, halo, dtype_bytes, n_arrays, iters))
    assert tobs.comm_schur_bytes(width % 13 + 1, iters) == jobs.comm_schur_bytes(
        width % 13 + 1, iters)
    assert tobs.comm_batched_icp_bytes(halo, iters) == jobs.comm_batched_icp_bytes(halo, iters)


def test_mesh_shapes_and_defaults(world4, world2):
    """The reference's defaulting (tests/test_dist.py:26-30) over a world
    of ranks: every rank on pixel_tile by default, one size given the other
    fills the world; pixel_tile the fast axis."""
    jm = jax_make_mesh(pixel_tiles=4, map_blocks=2)
    assert dict(jm.shape) == {"map_block": 2, "pixel_tile": 4}
    for results, n in ((world4, 4), (world2, 2)):
        for r, res in enumerate(results):
            m = res["mesh"]
            assert m["default"] == ({"map_block": 1, "pixel_tile": n},
                                    {"map_block": 0, "pixel_tile": r})
            half = n // 2
            assert m["tiles_only"][0] == {"map_block": n // half, "pixel_tile": half}
            assert m["blocks_only"][0] == {"map_block": half, "pixel_tile": n // half}
            assert m["tiles_only"][1] == {"map_block": r // half, "pixel_tile": r % half}
            assert m["all_blocks"] == ({"map_block": n, "pixel_tile": 1},
                                       {"map_block": r, "pixel_tile": 0})


def test_world_larger_than_layout_raises(world4):
    """A layout larger than the world fails the reference's assertion; a
    world larger than the layout raises ValueError naming both sizes (the
    reference would take its first devices)."""
    for res in world4:
        (e1, m1), (e2, m2) = res["mesh"]["errors"]
        assert e1 == "AssertionError" and "(4, 2, 4)" in m1
        assert e2 == "ValueError" and "world of 4 ranks" in m2 and "(1 ranks)" in m2


def test_make_mesh_without_a_process_group_is_trivial():
    m = make_mesh()
    assert m.shape == {"map_block": 1, "pixel_tile": 1} and m.groups["pixel_tile"] is None
    with pytest.raises(AssertionError):
        make_mesh(pixel_tiles=2)
    assert init_distributed(num_processes=1) is None
    x = torch.arange(12.0).reshape(3, 4)
    comm.reset()
    out = halo_exchange_rows(x, m, "pixel_tile", 2)
    assert torch.equal(out[2:5], x) and not out[:2].any() and not out[5:].any()
    assert comm.calls["ring"] == 0
    with pytest.raises(ValueError, match="halo"):
        halo_exchange_rows(x, m, "pixel_tile", 4)


def test_halo_exchange_rows(world4):
    """tests/test_dist.py:33-56 on a 4-rank axis: each haloed block equal
    to JAX's, zeros at the global borders; one ring exchange a call."""
    x = np.arange(16 * 8, dtype=np.float32).reshape(16, 8)
    jm = jax_make_mesh(pixel_tiles=4, map_blocks=2)
    for h in (1, 2):
        out = jax.shard_map(lambda a: jax_halo(a, "pixel_tile", h), mesh=jm,
                            in_specs=P("pixel_tile"), out_specs=P("pixel_tile"))(
            jnp.asarray(x))
        out = np.asarray(out).reshape(4, 4 + 2 * h, 8)
        for r, res in enumerate(world4):
            np.testing.assert_array_equal(_np(res["halo"][h]), out[r])
    for r, res in enumerate(world4):
        assert res["halo"]["ring_calls"] == 2
        assert res["halo"]["ring_bytes"] == tobs.comm_halo_bytes(8, 1) + tobs.comm_halo_bytes(8, 2)


# --- sharded unwrap and reconstruction -------------------------------------------


@pytest.fixture(scope="module")
def jax_unwrap():
    """JAX's sharded_unwrap over 2 pixel tiles, 8 sweeps, 3 a exchange
    (its result does not depend on the exchange period: tests/test_dist.py
    holds every period to the unsharded sweep)."""
    Phi, q, mask = _unwrap_problem()
    jm = jax_make_mesh(pixel_tiles=2, map_blocks=4)
    return np.asarray(jax_sharded_unwrap(jnp.asarray(Phi), jnp.asarray(q), jnp.asarray(mask),
                                         jm, iters=8, exchange_every=3))


@pytest.mark.parametrize("ee", EXCHANGE)
def test_sharded_unwrap_matches_unsharded(world4, jax_unwrap, ee):
    """2 x 2 world, 8 sweeps: the port's unsharded sweep bit for bit, JAX's
    sharded_unwrap within 1e-5; ceil(8 / min(ee, 32)) exchanges."""
    Phi, q, mask = _unwrap_problem()
    with one_thread():
        ref = spatial_quality_unwrap(torch.from_numpy(Phi), torch.from_numpy(q),
                                     torch.from_numpy(mask), iters=8)
    jout = jax_unwrap
    for res in world4:
        out = res["unwrap"][ee]
        assert torch.equal(out, ref)
        np.testing.assert_allclose(_np(out), jout, rtol=0, atol=1e-5)
        assert res["unwrap"][f"ring_calls_{ee}"] == -(-8 // min(ee, 32))
    _same_on_every_rank(world4, "unwrap")


def _unsharded(frames, cam, proj, spatial_iters):
    """The port's unsharded composition: K1's plain version, the sweep,
    ``triangulate_plane`` on every pixel."""
    cfg = PatternConfig(**CFG)
    with one_thread():
        out = fused_decode_triangulate(torch.from_numpy(frames), cam, proj, cfg,
                                       DecodeConfig())
        pts, mask, x_p = out.points.movedim(0, -1), out.mask > 0.5, out.x_p
        if spatial_iters:
            Phi = spatial_quality_unwrap(x_p * (TWO_PI / cfg.fringe_pitch), out.quality,
                                         mask, spatial_iters)
            x_p = Phi * (cfg.fringe_pitch / TWO_PI)
            H, W = x_p.shape
            v = torch.arange(H, dtype=torch.float32)[:, None].expand(H, W)
            u = torch.arange(W, dtype=torch.float32)[None, :].expand(H, W)
            pts, _ = triangulate_plane(cam, proj, u, v, x_p)
    return pts, mask, x_p, out.quality


@pytest.mark.parametrize("spatial_iters", SPATIAL)
@pytest.mark.parametrize("world", ["world1", "world2", "world4"])
def test_sharded_reconstruct_matches_unsharded(scene, world, spatial_iters, request):
    """K1 at each shard's row offset (and the haloed sweeps): the port's
    unsharded composition bit for bit on every rank; spatial_iters 4 runs
    one exchange a tile axis of more than one rank."""
    results = request.getfixturevalue(world)
    _, _, frames, cam, proj, _ = scene
    ref = _unsharded(frames, cam, proj, spatial_iters)
    for res in results:
        got = res["reconstruct"][spatial_iters]
        for a, b in zip(got, ref, strict=True):
            assert torch.equal(a, b)
        n = len(results)
        assert res["reconstruct"][f"ring_calls_{spatial_iters}"] == (
            1 if spatial_iters and n > 1 else 0)
    _same_on_every_rank(results, "reconstruct")


@pytest.mark.parametrize("spatial_iters", SPATIAL)
def test_sharded_reconstruct_matches_reference(scene, world4, spatial_iters):
    """Against JAX's sharded_reconstruct over 4 pixel tiles (the fused
    Pallas kernel a shard, interpret mode): K1's bounds (module docstring);
    JAX's own sharded result within 1e-5 of its unsharded kernel at 0
    sweeps (tests/test_dist.py:81-88)."""
    camj, projj, frames, *_ = scene
    jm = jax_make_mesh(pixel_tiles=4, map_blocks=2)
    cfg = JPatternConfig(**CFG)
    pj, mj, xj, qj = (np.asarray(a) for a in jax_sharded_reconstruct(
        jnp.asarray(frames), camj, projj, cfg, JDecodeConfig(), jm,
        spatial_iters=spatial_iters))
    if not spatial_iters:
        ker = jax_fused(jnp.asarray(frames), camj, projj, cfg, JDecodeConfig())
        np.testing.assert_array_equal(mj, np.asarray(ker.mask > 0.5))
        np.testing.assert_allclose(pj * mj[..., None],
                                   np.moveaxis(np.asarray(ker.points), 0, -1), atol=1e-5)
    pts, mask, x_p, q = (_np(a) for a in world4[0]["reconstruct"][spatial_iters])
    assert (mask != mj).mean() <= 1e-3
    both = mask & mj
    assert both.mean() > 0.3
    dx = np.abs(x_p - xj)
    assert (dx[both] > 1e-3).mean() <= 1e-4, dx[both].max()
    agree = both & (dx <= 1e-3)
    assert np.abs(pts - pj)[agree].max() <= 1e-2
    assert np.abs(q - qj).max() <= 1e-5


# --- the distributed BA and its recovery -----------------------------------------


def _ba_oracles(rows, map_blocks):
    (_, t_true), pr = _ba_problem()
    args = [pr[k] for k in ("ba_R0", "ba_t0", "ba_X0", "ba_s", "ba_p", "ba_w")]
    obs_n = pr["ba_n"] if rows == "plane" else None
    with one_thread():
        ref = bundle_adjust_reference(*map(torch.from_numpy, args), iters=BA_ITERS,
                                      huber_delta=HUBER,
                                      obs_n=None if obs_n is None else torch.from_numpy(obs_n))
    jm = jax_make_mesh(pixel_tiles=8 // map_blocks, map_blocks=map_blocks)
    jres = jax_dist_ba(*map(jnp.asarray, args), jm, iters=BA_ITERS, huber_delta=HUBER,
                       obs_n=None if obs_n is None else jnp.asarray(obs_n))
    return t_true, ref, jres


def _close(res, oracle, rms_rtol=1e-3):
    R, t, X, cost, rms = (_np(a) for a in res)
    np.testing.assert_allclose(t, _np(oracle.t), atol=1e-3)
    np.testing.assert_allclose(R, _np(oracle.R), atol=1e-5)
    np.testing.assert_allclose(X, _np(oracle.X), atol=1e-3)
    if rms_rtol is not None:
        np.testing.assert_allclose(float(rms), float(_np(oracle.rms)), rtol=rms_rtol)


@pytest.mark.parametrize("rows", ["point", "plane"])
@pytest.mark.parametrize("world,layout,blocks", [("world1", "blocks", 1), ("world2", "blocks", 2),
                                                 ("world4", "blocks", 4), ("world4", "2x2", 2)])
def test_distributed_ba_matches_reference(world, layout, blocks, rows, request):
    """Landmarks over 1, 2 and 4 map blocks and on a 2 x 2 world (both
    axes populated): the same bits on every rank, one all-reduce an
    iteration and one gather, test_dist.py's bounds against the port's
    single-device BA and JAX's distributed BA; point rows near the truth."""
    results = request.getfixturevalue(world)
    t_true, ref, jres = _ba_oracles(rows, max(blocks, 2))
    first = results[0]["ba"][(layout, rows)]
    for r in results:
        res, n_reduce, n_gather = r["ba"][(layout, rows)]
        assert all(torch.equal(a, b) for a, b in zip(res, first[0]))
        assert (n_reduce, n_gather) == (BA_ITERS, 1)
        _close(res, ref)
        _close(res, jres)
    if rows == "point":
        np.testing.assert_allclose(_np(first[0][1]), t_true, atol=0.2)


def test_ba_elastic_recovery(world4, tmp_path):
    """tests/test_aux.py:93-127: two iterations over 4 blocks, the
    checkpoint written by rank 0, the last eighth of the landmarks lost,
    resumed over 2 blocks of a 2 x 2 layout in the same world; against
    JAX's run of the case (8 blocks, then 4) and the truth. The case is
    noiseless, so both rms are float32 rounding (~1e-6) and are held to the
    reference's bound, < 1e-3, not to each other."""
    t_true, rc = _recovery_problem()
    j = {k: jnp.asarray(v) for k, v in rc.items()}
    m8 = jax_make_mesh(pixel_tiles=1, map_blocks=8)
    part = jax_dist_ba(j["rc_R"], j["rc_t0"], j["rc_X0"], j["rc_s"], j["rc_p"], j["rc_w"],
                       m8, iters=2)
    ckpt = tmp_path / "ba.npz"
    jax_save_ba_state(ckpt, part.R, part.t, part.X, iteration=2, cost=float(part.cost))
    m4 = jax_make_mesh(pixel_tiles=2, map_blocks=4)
    jres = jax_resume_ba(ckpt, j["rc_s"], j["rc_p"], j["rc_w"], j["rc_X0"], rc["rc_keep"],
                         m4, iters=8)
    for r in world4:
        res = r["recovery"]
        assert float(res[4]) < 1e-3 and float(jres.rms) < 1e-3
        np.testing.assert_allclose(_np(res[1]), t_true, atol=0.1)
        _close(res, jres, rms_rtol=None)
    _same_on_every_rank(world4, "recovery")


def test_reshard_fragments_pads_with_zero_weight_rows():
    _, rc = _recovery_problem()
    args = [torch.from_numpy(rc[k]) for k in ("rc_X0", "rc_s", "rc_p", "rc_w")]
    keep = rc["rc_keep"].copy()
    keep[:3] = False
    Xs, ss, ps, ws = reshard_fragments(*args, keep, n_blocks=4)
    assert Xs.shape[0] == 56 and ws.shape == (56, 3)
    assert torch.equal(Xs[:53], args[0][torch.from_numpy(keep)])
    assert not ws[53:].any() and not Xs[53:].any() and not ss[53:].any()


# --- the batch over map blocks, the dry run, the bring-up -------------------------


def test_batched_reconstruct_over_map_blocks(scene, inputs, world4):
    """4 scans over 2 map blocks of a 2 x 2 world: every scan the single
    call's bits (fused and unfused), on every rank; a batch that does not
    split raises."""
    _, _, _, cam, proj, _ = scene
    cfg = PatternConfig(**CFG)
    batch = torch.from_numpy(inputs["batch"])
    for fused, route in ((True, reconstruct_dense), (False, reconstruct_scan)):
        with one_thread():
            ref = [route(batch[i], cam, proj, cfg) for i in range(len(batch))]
        for r in world4:
            got = r["batch"][fused]
            for i in range(len(batch)):
                for a, b in zip(got, ref[i], strict=True):
                    assert torch.equal(a[i], b)
    for r in world4:
        assert "3 scans" in r["batch"]["ragged"]


def test_dryrun_multichip_on_the_cpu():
    from slr_torch.entry import dryrun_multichip

    dryrun_multichip(2, device="cpu", timeout_s=120)


def test_nccl_refuses_ranks_that_share_a_card(monkeypatch):
    """backend=None on a CUDA device takes NCCL, which needs one GPU a
    rank: with fewer GPUs than ranks it raises before joining, rather than
    sharing the card (a card shared needs backend='gloo')."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    with pytest.raises(RuntimeError, match="NCCL needs one GPU a rank"):
        init_distributed("localhost:1", num_processes=2, process_id=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed("localhost:1", num_processes=2, process_id=1)


@pytest.mark.cuda
def test_nccl_refuses_ranks_that_share_a_card_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="NCCL needs one GPU a rank"):
        init_distributed("localhost:1", num_processes=n, process_id=0)
