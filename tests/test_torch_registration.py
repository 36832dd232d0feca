"""slr_torch.registration and slr_torch.geom.se3 against the JAX reference (CPU).

The same numpy-seeded clouds, normals and poses go through ``slr`` and
``slr_torch``. JAX's band search runs its Pallas kernel in interpret mode
(``tests/conftest.py``), with 128-point tiles as its own tests run it. The
port's band search on the CPU is K8's plain version.

Tolerances, each with its reason:
- se3: 1e-6, float32 with the same formulas;
- distances in the expanded form |q|^2 + |t|^2 - 2 q.t lose ~eps |q|^2
  (|q| ~ 100 here: ~2e-3) to cancellation, and the port's band search
  computes sum((q - t)^2) instead: d2 within 1e-2, and indices equal except
  where the two nearest targets lie within that;
- JAX's band payload rounds normals to bf16: 4e-3 absolute;
- ICP poses: R 1e-5 and t 1e-3 on the exact route (float32 sums in another
  order, at the same fixed point); on the band route the bf16 normals move
  the JAX pose by ~1e-4, so 5e-4 and 2e-2 there.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr.geom import se3 as jse3
from slr.registration import band as jband
from slr.registration import features as jfeat
from slr.registration import icp as jicp
from slr.registration import nn as jnn
from slr.registration import normals as jnormals
from slr.registration import posegraph as jpg
from slr.registration import projective as jproj
from slr.geom import camera as jcam
from slr_torch.geom import se3 as tse3
from chip_smoke import (POSE_GRAPH_CASES, bumpy_surface, cu_constant, icp_case,
                        icp_grid_case, pose_graph_case, pose_graph_max_w2, rotation)
from slr_torch import observability as obs
from slr_torch.kernels import band_nn as kband
from slr_torch.kernels import icp as kicp
from slr_torch.kernels import pose_graph as kpg
from slr_torch.registration import band as tband
from slr_torch.registration import features as tfeat
from slr_torch.registration import icp as ticp
from slr_torch.registration import nn as tnn
from slr_torch.registration import normals as tnormals
from slr_torch.registration import posegraph as tpg
from slr_torch.registration import projective as tproj

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------- se3

@pytest.mark.parametrize("scale", [1e-6, 1e-5, 1e-3, 0.3, 2.5])
def test_se3_round_trips_match_reference(scale):
    """exp and log in both packages, and the round trips, to 1e-6 of the
    largest component. At rotation angles between ~1e-4 and ~1e-1 the
    reference's (1 - cos t)/t^2 loses float32 digits to cancellation in both
    packages, and their cos differ in the last ulp: there translations are
    held to 1e-4 of the largest component (both round trips are off by the
    same 5e-5 relative)."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    phi = (d * rng.uniform(0.5, 1.0, (64, 1)) * scale).astype(np.float32)
    xi = np.concatenate([rng.normal(size=(64, 3)) * 20, phi], 1).astype(np.float32)
    tol = 1e-4 if 1e-4 < scale < 1e-1 else 1e-6

    def close(a, b, rel):
        a, b = _np(a), np.asarray(b)
        np.testing.assert_allclose(a, b, atol=rel * max(np.abs(b).max(), 1e-30))

    Rj, tj = jse3.se3_exp(jnp.asarray(xi))
    Rt, tt = tse3.se3_exp(_t(xi))
    close(Rt, Rj, 1e-6)
    close(tt, tj, tol)
    close(tse3.se3_log(Rt, tt), jse3.se3_log(Rj, tj), tol)
    close(tse3.se3_log(Rt, tt), xi, tol)
    close(tse3.so3_log(tse3.so3_exp(_t(phi))), phi, 1e-6)
    close(tse3.so3_exp(_t(phi)), jse3.so3_exp(jnp.asarray(phi)), 1e-6)
    # compose, inverse, apply
    Ri, ti = tse3.se3_inverse(Rt, tt)
    Rc, tc = tse3.se3_compose(Rt, tt, Ri, ti)
    np.testing.assert_allclose(_np(Rc), np.broadcast_to(np.eye(3), (64, 3, 3)), atol=1e-6)
    np.testing.assert_allclose(_np(tc), 0.0, atol=1e-6 * float(tt.abs().max()))
    pts = rng.normal(size=(64, 5, 3)).astype(np.float32) * 100
    close(tse3.se3_apply(Rt, tt, _t(pts)), jse3.se3_apply(Rj, tj, jnp.asarray(pts)), tol)
    close(tse3.se3_apply(Rt, tt, _t(pts[:, 0])),
          jse3.se3_apply(Rj, tj, jnp.asarray(pts[:, 0])), tol)
    R0, t0 = tse3.se3_identity()
    assert torch.equal(R0, torch.eye(3)) and torch.equal(t0, torch.zeros(3))


def test_jacfwd_of_so3_log_at_identity_matches_reference():
    """Differentiable at exactly log(I): the Taylor branch, with the
    unselected branch NaN-free."""
    def jlog(x):
        return jse3.so3_log(jnp.eye(3) + x.reshape(3, 3))

    def tlog(x):
        return tse3.so3_log(torch.eye(3) + x.reshape(3, 3))

    Jj = np.asarray(jax.jacfwd(jlog)(jnp.zeros(9)))
    Jt = _np(torch.func.jacfwd(tlog)(torch.zeros(9)))
    assert np.isfinite(Jt).all()
    np.testing.assert_allclose(Jt, Jj, atol=1e-6)
    # and of se3_exp / so3_exp at 0
    Jj = np.asarray(jax.jacfwd(lambda x: jse3.se3_exp(x)[0])(jnp.zeros(6)))
    Jt = _np(torch.func.jacfwd(lambda x: tse3.se3_exp(x)[0])(torch.zeros(6)))
    np.testing.assert_allclose(Jt, Jj, atol=1e-6)


# ---------------------------------------------------------------- nn, normals

def _close_nn(idx_t, d2_t, idx_j, d2_j, qry, tgt, tol=1e-2):
    """Indices equal except where the two nearest lie within ``tol``."""
    np.testing.assert_allclose(_np(d2_t), np.asarray(d2_j), atol=tol)
    idx_t, idx_j = _np(idx_t), np.asarray(idx_j)
    off = np.flatnonzero(idx_t != idx_j)
    for i in off:
        a = np.sum((qry[i] - tgt[idx_t[i]]) ** 2)
        b = np.sum((qry[i] - tgt[idx_j[i]]) ** 2)
        assert abs(a - b) <= tol, (i, a, b)
    assert len(off) <= 0.01 * len(idx_t)


@pytest.mark.parametrize("tile", [256, 2048])
def test_nearest_neighbors_matches_reference(tile):
    rng = np.random.default_rng(1)
    tgt = rng.uniform(-50, 50, (1500, 3)).astype(np.float32)
    qry = rng.uniform(-50, 50, (400, 3)).astype(np.float32)
    valid = rng.random(1500) > 0.2
    i_j, d_j = jnn.nearest_neighbors(jnp.asarray(qry), jnp.asarray(tgt),
                                     jnp.asarray(valid), tile=tile)
    i_t, d_t = tnn.nearest_neighbors(_t(qry), _t(tgt), torch.from_numpy(valid),
                                     tile=tile)
    assert i_t.dtype == torch.int64 and bool(torch.from_numpy(valid)[i_t].all())
    _close_nn(i_t, d_t, i_j, d_j, qry, tgt)


def test_grid_normals_match_reference():
    rng = np.random.default_rng(4)
    H, W = 24, 31
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    z = 450 + 10 * np.sin(u / 5.0) + 6 * np.cos(v / 4.0)
    pts = np.stack([(u - W / 2) * z / 300, (v - H / 2) * z / 300, z], -1)
    pts = (pts + rng.normal(0, 0.01, pts.shape)).astype(np.float32)
    mask = rng.random((H, W)) > 0.15
    for m in (mask, None):
        nj = jnormals.grid_normals(jnp.asarray(pts), None if m is None else jnp.asarray(m))
        nt = tnormals.grid_normals(_t(pts), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(_np(nt), np.asarray(nj), atol=1e-5)


# ---------------------------------------------------------------- band (K8's plain version)

def _jax_band_sorted(qry, tgt, nrm, valid, r, b_max=None):
    """JAX's band_nn_sorted (interpret mode, 128-point tiles), results put
    back in the original query order."""
    bt = jband.build_band_target(jnp.asarray(tgt), jnp.asarray(nrm),
                                 None if valid is None else jnp.asarray(valid), tt=128)
    order = np.argsort(np.asarray(jnp.asarray(qry) @ bt.axis), kind="stable")
    Q = len(qry)
    Qp = -(-Q // 128) * 128
    qc = np.full((3, Qp), 1e9, np.float32)
    qc[:, :Q] = qry[order].T
    qv = np.arange(Qp) < Q
    if b_max is None:
        b_max = int(bt.tlo.shape[0])
    d2, p, n, i = (np.asarray(x)[:Q] for x in jband.band_nn_sorted(
        jnp.asarray(qc), jnp.asarray(qv), bt, r, b_max, qt=128))
    out = [np.empty_like(x) for x in (d2, p, n, i)]
    for o, x in zip(out, (d2, p, n, i)):
        o[order] = x
    return out


def _port_band_sorted(qry, tgt, nrm, valid, r, qt=128, tt=128):
    bt = tband.build_band_target(_t(tgt), _t(nrm), None if valid is None
                                 else torch.from_numpy(valid), tt=tt)
    order = torch.sort(_t(qry) @ bt.axis, stable=True).indices
    res = tband.band_nn_sorted(_t(qry)[order].T.contiguous(),
                               torch.ones(len(qry), dtype=torch.bool), bt, r, qt=qt)
    out = [torch.empty_like(x) for x in res]
    for o, x in zip(out, res):
        o[order] = x
    return [_np(x) for x in out]


def _band_scene(seed, n_t=3000, n_q=1100):
    rng = np.random.default_rng(seed)
    tgt = rng.uniform(-80, 80, (n_t, 3)).astype(np.float32)
    tgt[:, 2] *= 0.2                       # anisotropic: the axis matters
    qry = rng.uniform(-90, 90, (n_q, 3)).astype(np.float32)
    qry[:, 2] *= 0.2
    nrm = rng.normal(size=(n_t, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return rng, tgt, qry, nrm


@pytest.mark.parametrize("masked", [False, True])
def test_band_plain_version_matches_reference(masked):
    rng, tgt, qry, nrm = _band_scene(2)
    valid = rng.random(len(tgt)) > 0.1 if masked else None
    r = 12.0
    d2_j, p_j, n_j, i_j = _jax_band_sorted(qry, tgt, nrm, valid, r)
    d2_t, p_t, n_t, i_t = _port_band_sorted(qry, tgt, nrm, valid, r)
    hit_j, hit_t = i_j >= 0, i_t >= 0
    # the same hit set, but for a query whose nearest sits at r within the
    # expanded form's rounding
    border = np.abs(np.where(hit_j, d2_j, d2_t) - r * r) < 1e-2
    assert np.array_equal(hit_j | border, hit_t | border)
    both = hit_j & hit_t
    assert both.sum() > 700
    np.testing.assert_allclose(d2_t[both], d2_j[both], atol=1e-2)
    same = both & (i_t == i_j)
    assert (both & ~same).sum() <= 2          # near-ties only
    np.testing.assert_array_equal(p_t[same], p_j[same])
    np.testing.assert_allclose(n_t[same], n_j[same], atol=4e-3)   # bf16 payload
    np.testing.assert_array_equal(n_t[same], nrm[i_t[same]])      # the port's fp32
    assert np.all(np.isinf(d2_t[~hit_t])) and np.all(p_t[~hit_t] == 0)
    if masked:
        assert valid[i_t[hit_t]].all()


def test_band_nn_vs_scipy():
    from scipy.spatial import cKDTree

    _, tgt, qry, _ = _band_scene(2, 4000, 1500)
    r = 12.0
    idx, d2 = tband.band_nearest_neighbors(_t(qry), _t(tgt), max_corr_dist=r)
    d_ref, i_ref = cKDTree(tgt).query(qry)
    within = d_ref <= r
    assert within.sum() > 1000
    np.testing.assert_array_equal(_np(idx)[within], i_ref[within])
    # sum((q - t)^2): no cancellation
    np.testing.assert_allclose(np.sqrt(_np(d2)[within]), d_ref[within], rtol=1e-5,
                               atol=1e-5)
    assert np.all(_np(idx)[~within] == -1) and np.all(np.isinf(_np(d2)[~within]))


@pytest.mark.parametrize("qt,tt", [(128, 128), (64, 32), (256, 512)])
def test_band_result_does_not_depend_on_tiles(qt, tt):
    """Ragged query counts (1100 is no multiple of any tile here) and any
    tiling give the same answer, bit for bit."""
    _, tgt, qry, nrm = _band_scene(5)
    ref = _port_band_sorted(qry, tgt, nrm, None, 10.0)
    got = _port_band_sorted(qry, tgt, nrm, None, 10.0, qt=qt, tt=tt)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_band_nn_respects_valid_mask():
    tgt = np.asarray([[0.0, 0, 0], [3.0, 0, 0], [50.0, 0, 0]], np.float32)
    qry = np.asarray([[1.0, 0, 0]], np.float32)
    valid = np.asarray([False, True, True])
    for idx, d2 in (tband.band_nearest_neighbors(_t(qry), _t(tgt),
                                                 target_valid=torch.from_numpy(valid),
                                                 max_corr_dist=10.0),
                    jband.band_nearest_neighbors(jnp.asarray(qry), jnp.asarray(tgt),
                                                 target_valid=jnp.asarray(valid),
                                                 max_corr_dist=10.0, qt=128, tt=128)):
        assert int(idx[0]) == 1
        assert abs(float(d2[0]) - 4.0) < 1e-3


def test_band_nn_duplicate_targets_tie_break():
    """Duplicate targets: the lowest sorted position wins, which the stable
    sort makes the lowest original index (the reference: lowest lane)."""
    rng = np.random.default_rng(0)
    tgt = np.array([[0.0, 0, 0], [5, 0, 0], [5, 0, 0], [9, 0, 0]], np.float32)
    tgt = np.concatenate([tgt, rng.uniform(20, 90, (200, 3)).astype(np.float32)])
    qry = np.array([[5.1, 0, 0], [0.2, 0, 0]], np.float32)
    idx_t, d2_t = tband.band_nearest_neighbors(_t(qry), _t(tgt), max_corr_dist=10.0)
    idx_j, _ = jband.band_nearest_neighbors(jnp.asarray(qry), jnp.asarray(tgt),
                                            max_corr_dist=10.0, qt=128, tt=128)
    assert _np(idx_t).tolist() == [1, 0] == np.asarray(idx_j).tolist()
    assert abs(float(d2_t[0]) - 0.01) < 1e-5


def test_band_empty_tile_and_no_truncation():
    """A query tile far from every target has an empty band and misses; a
    band wider than the reference's suggested cap is walked to its end."""
    _, tgt, qry, nrm = _band_scene(7, 2000, 300)
    bt = tband.build_band_target(_t(tgt), _t(nrm), tt=32)
    # a tile of queries before every target (keys -1e5), then the scene's
    # queries, then a tile of invalid ones
    far = (bt.axis[:, None] * -1e5).expand(3, 128)
    qs = torch.cat([far, _t(qry)[torch.sort(_t(qry) @ bt.axis, stable=True).indices].T,
                    -far], dim=1).contiguous()
    qv = torch.ones(qs.shape[1], dtype=torch.bool)
    qv[-128:] = False
    jstart, jend = kband.tile_bands(bt.axis @ qs, qv, bt, 10.0, 128)
    assert int(jend[0] - jstart[0]) <= 0 and int(jend[-1] - jstart[-1]) <= 0
    d2, pts, nn, idx = tband.band_nn_sorted(qs, qv, bt, 10.0, b_max=1)
    scene = slice(128, 428)
    miss = torch.ones_like(qv)
    miss[scene] = False
    assert bool((idx[miss] == -1).all()) and bool(torch.isinf(d2[miss]).all())
    # every hit equals the brute force, though the bands run wider than the
    # reference's cap measured at other query positions (as after an ICP
    # step moved the cloud)
    b_max = tband.suggest_b_max(_t(qry) * 0.1, _t(tgt), 10.0, tt=32)
    assert int((jend - jstart).max()) > b_max
    ref = torch.cdist(qs[:, scene].T.double(), _t(tgt).double()).argmin(1)
    hit = idx[scene] >= 0
    assert bool((idx[scene][hit] == ref[hit]).all()) and int(hit.sum()) > 200


def test_band_target_and_widths_match_reference():
    """The principal axis within float32 summation order (3e-6 here), so
    keys closer than that may swap places: the sorted keys and tile bounds
    within 1e-3, band widths within one tile."""
    _, tgt, qry, nrm = _band_scene(3)
    valid = np.random.default_rng(0).random(len(tgt)) > 0.1
    bt_j = jband.build_band_target(jnp.asarray(tgt), jnp.asarray(nrm), jnp.asarray(valid),
                                   tt=128)
    bt_t = tband.build_band_target(_t(tgt), _t(nrm), torch.from_numpy(valid), tt=128)
    np.testing.assert_allclose(_np(bt_t.axis), np.asarray(bt_j.axis), atol=1e-5)
    for a, b in ((bt_t.tlo, bt_j.tlo), (bt_t.thi, bt_j.thi)):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-5, atol=1e-3)
    # invalid targets sort last, at BIG
    n_ok = int(valid.sum())
    assert bool((bt_t.coords[:, n_ok:] == tband.BIG).all())
    assert sorted(_np(bt_t.index[:n_ok]).tolist()) == np.flatnonzero(valid).tolist()
    np.testing.assert_array_equal(_np(bt_t.normals[:, :n_ok]).T, nrm[_np(bt_t.index[:n_ok])])
    w_j = np.asarray(jband.band_widths(jnp.asarray(qry), jnp.ones(len(qry), bool), bt_j,
                                       10.0, qt=128))
    w_t = _np(tband.band_widths(_t(qry), torch.ones(len(qry), dtype=torch.bool), bt_t, 10.0))
    assert np.abs(w_t - w_j).max() <= 1 and (w_t == w_j).mean() > 0.9
    b_j = jband.suggest_b_max(jnp.asarray(qry), jnp.asarray(tgt), 10.0, qt=128, tt=128)
    assert abs(tband.suggest_b_max(_t(qry), _t(tgt), 10.0) - b_j) <= 2


# ---------------------------------------------------------------- ICP

def _icp_arrays(kw):
    """The numpy arrays of ``icp_case``'s keyword arguments, in order."""
    return [_np(kw[k]) for k in ("src", "tgt", "tgt_normals", "src_valid", "tgt_valid", "R0",
                                 "t0") if k in kw]


def test_icp_exact_route_matches_reference():
    kw, (R_true, t_true) = icp_case("cpu", 1500, 7)
    src, tgt, n_tgt = _icp_arrays(kw)
    rj = jicp.icp_point_to_plane(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(n_tgt),
                                 iters=12, max_corr_dist=20.0, nn_tile=512,
                                 nn_method="exact")
    rt = ticp.icp_point_to_plane(_t(src), _t(tgt), _t(n_tgt), iters=12,
                                 max_corr_dist=20.0, nn_tile=512, nn_method="auto")
    np.testing.assert_allclose(_np(rt.R), np.asarray(rj.R), atol=1e-5)
    np.testing.assert_allclose(_np(rt.t), np.asarray(rj.t), atol=1e-3)
    np.testing.assert_allclose(_np(rt.R), R_true, atol=2e-3)
    np.testing.assert_allclose(float(rt.inlier_frac), float(rj.inlier_frac), atol=1e-3)
    assert float(rt.rms) < 0.2


def test_icp_band_route_matches_reference():
    """The band route with a masked target and an initial pose; JAX's band
    payload rounds normals to bf16, hence the looser pose tolerance."""
    kw, (R_true, t_true) = icp_case("cpu", 2000, 8, masked=True)
    src, tgt, n_tgt, sv, tv, R0, t0 = _icp_arrays(kw)
    rj = jicp.icp_point_to_plane(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(n_tgt), jnp.asarray(sv),
        jnp.asarray(tv), jnp.asarray(R0), jnp.asarray(t0), iters=8,
        max_corr_dist=15.0, nn_method="band")
    rt = ticp.icp_point_to_plane(
        _t(src), _t(tgt), _t(n_tgt), torch.from_numpy(sv), torch.from_numpy(tv),
        _t(R0), _t(t0), iters=8, max_corr_dist=15.0, nn_method="band")
    re = ticp.icp_point_to_plane(
        _t(src), _t(tgt), _t(n_tgt), torch.from_numpy(sv), torch.from_numpy(tv),
        _t(R0), _t(t0), iters=8, max_corr_dist=15.0, nn_method="exact")
    np.testing.assert_allclose(_np(rt.R), np.asarray(rj.R), atol=5e-4)
    np.testing.assert_allclose(_np(rt.t), np.asarray(rj.t), atol=2e-2)
    # the port's band and exact routes see the same correspondences
    np.testing.assert_allclose(_np(rt.R), _np(re.R), atol=1e-5)
    np.testing.assert_allclose(_np(rt.t), _np(re.t), atol=1e-3)
    np.testing.assert_allclose(_np(rt.R), R_true, atol=2e-3)
    np.testing.assert_allclose(_np(rt.t), t_true, atol=0.5)


def test_icp_nn_method_resolution():
    """"auto" takes exact up to the crossover; above it the voxel hash on
    a CPU tensor (the reference's CPU rule) and the band search on a CUDA
    one (its accelerator rule)."""
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert ticp._resolve_nn_method("auto", 4096, 4096, cpu) == "exact"
    assert ticp._resolve_nn_method("auto", 4096, 4096, card) == "exact"
    assert ticp._resolve_nn_method("auto", 262144, 262144, cpu) == "voxel"
    assert ticp._resolve_nn_method("auto", 262144, 262144, card) == "band"
    assert ticp._resolve_nn_method("exact", 262144, 262144, cpu) == "exact"
    assert ticp._resolve_nn_method("voxel", 10, 10, card) == "voxel"
    assert ticp._resolve_nn_method("band", 10, 10, cpu) == "band"
    with pytest.raises(ValueError):
        ticp._resolve_nn_method("kdtree", 10, 10, cpu)


# the NN route's kernel takes every CUDA call on the exact search: "auto"
# up to 24000^2 pairs, "exact" at any size; a target past a block's 232,448
# bytes of shared memory (14,428 points) is staged in chunks; the CPU never
_ICP_ROUTE = [(4096, 4096, "cuda", True), (4096, 4096, "cpu", False),
              (40_000, 14_400, "cuda", True), (40_001, 14_400, "cuda", False),
              (40_000, 14_401, "cuda", False), (24_000, 24_000, "cuda", True),
              (576_000, 1_000, "cuda", True), (576_001, 1_000, "cuda", False),
              (512, 14_428, "cuda", True),
              (512, 14_429, "cuda", True), (512, 14_428, "cpu", False),
              (1, 1, "cuda", True), (0, 4096, "cuda", True), (4096, 0, "cuda", True)]


@pytest.mark.parametrize("N,M,device,kernel", _ICP_ROUTE)
def test_icp_kernel_route_at_its_edges(N, M, device, kernel):
    """``takes_kernel`` at the crossover and at the shared-memory edge, on
    either device (the device handed in: no card needed): the exact search
    on the card, staged whole up to 14,428 target points and in chunks
    past them; "exact" on the card at any size, the band and voxel
    routes never."""
    assert kicp.takes_kernel(N, M, torch.device(device)) == kernel
    assert kicp.takes_kernel(N, M, device) == kernel
    exact = ticp._resolve_nn_method("auto", N, M, device) == "exact"
    assert kernel == (device == "cuda" and exact)
    assert kicp.takes_kernel(N, M, device, "exact") == (device == "cuda")
    assert not kicp.takes_kernel(N, M, device, "band")
    assert not kicp.takes_kernel(N, M, device, "voxel")
    assert kicp.smem_bytes(M) == kicp.HEAD_BYTES + 16 * min(M, 14_428) <= kicp.SMEM_MAX


def test_icp_kernel_constants_match_the_source():
    """The wrapper's shared-memory rule reads the kernel's own numbers,
    and stages chunks as the kernel does."""
    assert kicp.HEAD_BYTES == cu_constant("icp", "SLR_ICP_HEAD_BYTES")
    assert kicp.SMEM_MAX == cu_constant("icp", "SLR_ICP_SMEM_MAX")
    source = (Path(__file__).resolve().parents[1] / "slr_torch" / "kernels" / "csrc"
              / "icp.cu").read_text()
    assert ("#define SLR_ICP_CHUNK ((SLR_ICP_SMEM_MAX - SLR_ICP_HEAD_BYTES) / 16)"
            in source)
    assert kicp.CHUNK == (kicp.SMEM_MAX - kicp.HEAD_BYTES) // 16 == 14_428


def _fake_icp(mode, E=2, N=10, M=12, **change):
    """Fake CUDA tensors (metadata only) of ``kicp.align``'s arguments."""
    with mode:
        kw = dict(src=torch.empty((E, N, 3), device="cuda:0"),
                  tgt=torch.empty((E, M, 3), device="cuda:0"),
                  tgt_n=torch.empty((E, M, 3), device="cuda:0"),
                  src_valid=torch.empty((E, N), dtype=torch.bool, device="cuda:0"),
                  R0=torch.empty((E, 3, 3), device="cuda:0"))
        kw.update({k: v() for k, v in change.items()})
    return kw


@pytest.mark.parametrize("case", ["cpu", "dtype", "shape", "rank", "mask_dtype", "iters",
                                  "no_target", "past_int32_offsets", "polish_grid_of",
                                  "polish_mask"])
def test_icp_kernel_wrapper_refuses_before_any_build(case, monkeypatch):
    """The wrapper raises ``ValueError`` on CPU tensors, another dtype,
    shape or rank, fewer than one iteration, an empty target (the plain
    search raises on one too), a cloud past the kernel's int32 offsets, or
    grids that no index maps to edges, before it builds or loads the
    library."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def built():
        raise AssertionError("the library was built")

    monkeypatch.setattr(kicp, "library", built)
    mode = FakeTensorMode()
    cuda = "cuda:0"
    calls = {
        "cpu": lambda: kicp.align(torch.zeros(1, 4, 3), torch.zeros(1, 4, 3),
                                  torch.zeros(1, 4, 3)),
        "dtype": lambda: kicp.align(**_fake_icp(
            mode, src=lambda: torch.empty((2, 10, 3), dtype=torch.float64, device=cuda))),
        "shape": lambda: kicp.align(**_fake_icp(
            mode, tgt_n=lambda: torch.empty((2, 12, 2), device=cuda))),
        "rank": lambda: kicp.align(**_fake_icp(mode, src=lambda: torch.empty((10, 3),
                                                                             device=cuda))),
        "mask_dtype": lambda: kicp.align(**_fake_icp(
            mode, src_valid=lambda: torch.empty((2, 10), dtype=torch.uint8, device=cuda))),
        "iters": lambda: kicp.align(**_fake_icp(mode), iters=0),
        "no_target": lambda: kicp.align(**_fake_icp(mode, M=0)),
        "past_int32_offsets": lambda: kicp.align(**_fake_icp(mode, E=1,
                                                             N=kicp.MAX_POINTS + 1)),
        "polish_grid_of": lambda: kicp.polish(*_fake_grids(mode, E=2, G=3), None, None),
        "polish_mask": lambda: kicp.polish(*_fake_grids(mode, E=2, G=2, mask=torch.float32),
                                           None, None),
    }
    with mode, pytest.raises(ValueError):
        calls[case]()


def _fake_grids(mode, E, G, mask=torch.bool, H=6, W=8):
    with mode:
        return (torch.empty((E, 10, 3), device="cuda:0"), None,
                torch.empty((G, H, W, 3), device="cuda:0"),
                torch.empty((G, H, W), dtype=mask, device="cuda:0"),
                torch.empty((G, H, W, 3), device="cuda:0"))


def test_icp_on_cpu_tensors_launches_nothing():
    """CPU tensors run the plain loops, bit for bit, and count no launch."""
    counts = obs.snapshot().counts
    before = [counts.get(f"launches.{k}", 0) for k in ("icp", "icp_polish")]
    kw, _ = icp_case("cpu", 500, 4, masked=True)
    got = ticp.icp_point_to_plane(**kw, iters=4)
    want = ticp.icp_point_to_plane_reference(**kw, iters=4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    args, _ = icp_grid_case("cpu")
    got = tproj.icp_projective(*args, iters=4)
    want = tproj.icp_projective_reference(*args, iters=4)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    counts = obs.snapshot().counts
    assert [counts.get(f"launches.{k}", 0) for k in ("icp", "icp_polish")] == before


def test_batched_fine_on_cpu_equals_the_per_edge_loops():
    """``_batched_fine`` on CPU tensors (vmap over the plain loops, NN
    route then the projective polish on each edge's grid) gives each edge
    the result of the plain loops called on it alone."""
    from slr_torch.config import RegistrationConfig
    from slr_torch.pipeline import registerfuse as trf

    (src, _, grid, mask, normals, cam), _ = icp_grid_case("cpu")
    valid = mask.reshape(-1)
    tgt_n = normals.reshape(-1, 3)[valid][::3]
    E = 3
    shifts = torch.tensor([[0.0, 0.0, 0.0], [0.3, -0.2, 0.1], [-0.4, 0.1, 0.5]])
    # 0.05 mm of noise, so the Huber weights are not set by rounding
    noise = np.random.default_rng(5).normal(0, 0.05, (E, *src.shape)).astype(np.float32)
    srcs = src[None] + shifts[:, None] + torch.from_numpy(noise)
    grids = (torch.stack([grid, grid + 0.2]), torch.stack([mask, mask]),
             torch.stack([normals, normals]))
    tgt_idx = torch.tensor([0, 1, 0])
    tp = torch.stack([grids[0][g].reshape(-1, 3)[valid][::3] for g in tgt_idx.tolist()])
    tn = tgt_n[None].expand(E, -1, -1)
    rc = RegistrationConfig(icp_iters=6)
    got = trf._batched_fine(srcs, tp, tn, rc, grids=grids, cam=cam, tgt_idx=tgt_idx)
    ones = torch.ones(src.shape[0], dtype=torch.bool)
    for e in range(E):
        g = int(tgt_idx[e])
        r = ticp.icp_point_to_plane_reference(srcs[e], tp[e], tn[e], iters=6,
                                              max_corr_dist=rc.icp_max_corr_dist)
        r = tproj.icp_projective_reference(srcs[e], ones, grids[0][g], grids[1][g],
                                           grids[2][g], cam, R0=r.R, t0=r.t, iters=8,
                                           max_corr_dist=rc.icp_max_corr_dist)
        np.testing.assert_allclose(_np(got.R[e]), _np(r.R), atol=1e-6)
        np.testing.assert_allclose(_np(got.t[e]), _np(r.t), atol=1e-5)
        np.testing.assert_allclose(float(got.rms[e]), float(r.rms), rtol=1e-5)
        np.testing.assert_allclose(float(got.inlier_frac[e]), float(r.inlier_frac), atol=1e-5)


# ---------------------------------------------------------------- voxel hash

def _voxel_case(seed):
    """Targets: a dense 30 mm cube (~55 points a 10 mm voxel, far over the
    buckets), a sparse 2 m box (mostly empty neighbourhoods) and a far
    cluster beyond the 1024-voxel window; 10 % masked. Queries near the
    dense points, in the sparse box, below the window's anchor and past
    its far end."""
    rng = np.random.default_rng(seed)
    tgt = np.concatenate([rng.uniform(0, 30, (1500, 3)), rng.uniform(0, 2000, (500, 3)),
                          rng.uniform(20000, 20100, (20, 3))]).astype(np.float32)
    valid = rng.random(len(tgt)) > 0.1
    qry = np.concatenate([tgt[:1500:3] + rng.normal(0, 2.0, (500, 3)),
                          rng.uniform(0, 2000, (300, 3)),
                          rng.uniform(-600, -400, (20, 3)),
                          rng.uniform(11000, 12000, (20, 3))]).astype(np.float32)
    return tgt, valid, qry


@pytest.mark.parametrize("seed,bucket_cap", [(21, 8), (22, 4), (23, 16)])
def test_voxel_hash_matches_reference(seed, bucket_cap):
    """The table, its row ids and anchor equal JAX's; every query's index
    equal and d2 within 1e-5 relative; masked and out-of-window points never
    found, out-of-window queries and empty neighbourhoods missed."""
    from slr.registration import voxel as jvox
    from slr_torch.registration import voxel as tvox

    tgt, valid, qry = _voxel_case(seed)
    size = 10.0
    tj = jvox.build_voxel_hash(jnp.asarray(tgt), jnp.asarray(valid), size,
                               bucket_cap=bucket_cap)
    tt = tvox.build_voxel_hash(_t(tgt), torch.from_numpy(valid), size,
                               bucket_cap=bucket_cap)
    for a, b in zip(tt, tj):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    kept, row_ids = _np(tt[0]), _np(tt[1])
    assert (kept >= 0).sum(axis=1).max() == bucket_cap       # buckets overflowed
    # masked and out-of-window points share the sentinel's row only
    outside = np.concatenate([np.flatnonzero(~valid), np.arange(2000, len(tgt))])
    assert not np.isin(outside, kept[row_ids != tvox._INVALID_VID]).any()
    ij, dj = jvox.voxel_hash_nn(jnp.asarray(qry), jnp.asarray(tgt), *tj, size,
                                bucket_cap=bucket_cap)
    it, dt = tvox.voxel_hash_nn(_t(qry), _t(tgt), *tt, size, bucket_cap=bucket_cap)
    ij, dj, it, dt = np.asarray(ij), np.asarray(dj), _np(it), _np(dt)
    np.testing.assert_array_equal(it, ij)
    hit = ij >= 0
    np.testing.assert_allclose(dt[hit], dj[hit], rtol=1e-5)
    assert np.isinf(dt[~hit]).all() and np.isinf(dj[~hit]).all()
    assert (it[-40:] == -1).all()                            # outside the window
    assert (it[:500] >= 0).all() and (it[500:800] == -1).any()
    assert valid[it[hit]].all() and (it[hit] < 2000).all()


def test_icp_voxel_route_matches_reference():
    """The voxel route against JAX's, with a masked target and an initial
    pose: the same correspondences from the same buckets."""
    kw, (R_true, t_true) = icp_case("cpu", 2000, 9, masked=True)
    src, tgt, n_tgt, sv, tv, R0, t0 = _icp_arrays(kw)
    rj = jicp.icp_point_to_plane(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(n_tgt), jnp.asarray(sv),
        jnp.asarray(tv), jnp.asarray(R0), jnp.asarray(t0), iters=8,
        max_corr_dist=15.0, nn_method="voxel")
    rt = ticp.icp_point_to_plane(
        _t(src), _t(tgt), _t(n_tgt), torch.from_numpy(sv), torch.from_numpy(tv),
        _t(R0), _t(t0), iters=8, max_corr_dist=15.0, nn_method="voxel")
    np.testing.assert_allclose(_np(rt.R), np.asarray(rj.R), atol=5e-4)
    np.testing.assert_allclose(_np(rt.t), np.asarray(rj.t), atol=2e-2)
    np.testing.assert_allclose(float(rt.inlier_frac), float(rj.inlier_frac), atol=1e-3)
    np.testing.assert_allclose(_np(rt.R), R_true, atol=2e-3)
    np.testing.assert_allclose(_np(rt.t), t_true, atol=0.5)


def test_icp_auto_above_crossover_on_cpu_is_the_voxel_route():
    """Just above 24000^2 pairs "auto" on CPU tensors gives the voxel
    route's pose, bit for bit."""
    kw, _ = icp_case("cpu", 24_001, 10)
    args = (kw["src"], kw["tgt"], kw["tgt_normals"])
    ra = ticp.icp_point_to_plane(*args, iters=3, max_corr_dist=10.0)
    rv = ticp.icp_point_to_plane(*args, iters=3, max_corr_dist=10.0, nn_method="voxel")
    assert torch.equal(ra.R, rv.R) and torch.equal(ra.t, rv.t)


def test_icp_projective_matches_reference():
    """Dense projective association on an organized grid, from a small
    offset pose: both packages on the same arrays."""
    (src, sv, grid, mask, n_grid, ct), (R_m, _) = icp_grid_case("cpu")
    cj = jcam.Camera(*(jnp.asarray(_np(x)) for x in ct))
    rj = jproj.icp_projective(*(jnp.asarray(_np(x)) for x in (src, sv, grid, mask, n_grid)),
                              cj, iters=10, max_corr_dist=10.0)
    rt = tproj.icp_projective(src, sv, grid, mask, n_grid, ct, iters=10, max_corr_dist=10.0)
    np.testing.assert_allclose(_np(rt.R), np.asarray(rj.R), atol=1e-5)
    np.testing.assert_allclose(_np(rt.t), np.asarray(rj.t), atol=1e-3)
    np.testing.assert_allclose(float(rt.rms), float(rj.rms), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(_np(rt.R), R_m, atol=2e-3)


# ---------------------------------------------------------------- features

def _feature_pair():
    """Source coordinates on a 1/16 grid within +-64: every |q|^2 + |t|^2 -
    2 q.t is exact in float32, so both packages see the same distances (at
    scan coordinates, |q| ~ 500, the self-distance of ``_knn`` is rounding
    noise of ~0.03 mm^2, which FPFH's 1/sqrt(d2) weights magnify)."""
    src, n_src = bumpy_surface(700, 3, half=60.0)
    src = np.round(src * 16) / 16
    R_true = rotation([0.05, 0.1, 0.4])
    t_true = np.array([30.0, -25.0, 15.0], np.float32)
    tgt = (src @ R_true.T + t_true).astype(np.float32)
    return src, n_src, tgt, (n_src @ R_true.T).astype(np.float32), R_true, t_true


def test_knn_and_fpfh_match_reference():
    src, n_src, _, _, _, _ = _feature_pair()
    i_j, d_j = jfeat._knn(jnp.asarray(src), jnp.asarray(src), k=12, tile=256)
    i_t, d_t = tfeat._knn(_t(src), _t(src), k=12, tile=256)
    # the same neighbour sets; two of them may swap places within rounding
    np.testing.assert_array_equal(np.sort(_np(i_t), 1), np.sort(np.asarray(i_j), 1))
    np.testing.assert_allclose(_np(d_t), np.asarray(d_j), atol=1e-2)
    fj = np.asarray(jfeat.fpfh_features(jnp.asarray(src), jnp.asarray(n_src), k=12))
    ft = _np(tfeat.fpfh_features(_t(src), _t(n_src), k=12))
    np.testing.assert_allclose(ft, fj, atol=1e-5)


def test_kabsch_batched_matches_reference():
    rng = np.random.default_rng(6)
    P = rng.normal(size=(5, 7, 3)).astype(np.float32) * 30
    R = np.stack([rotation(rng.normal(size=3)) for _ in range(5)])
    Q = (np.einsum("bij,bnj->bni", R, P) + rng.normal(size=(5, 1, 3)) * 10
         ).astype(np.float32)
    w = rng.random((5, 7)).astype(np.float32)
    Rt, tt = tfeat._kabsch(_t(P), _t(Q), _t(w))
    for b in range(5):
        Rj, tj = jfeat._kabsch(jnp.asarray(P[b]), jnp.asarray(Q[b]), jnp.asarray(w[b]))
        np.testing.assert_allclose(_np(Rt[b]), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(_np(tt[b]), np.asarray(tj), atol=1e-3)


def test_ransac_with_reference_draw_matches_reference(monkeypatch):
    """The port's RANSAC fed JAX's own hypothesis draw (keys split from
    PRNGKey(0), as ``ransac_align`` draws) agrees with JAX's result."""
    src, n_src, tgt, n_tgt, R_true, t_true = _feature_pair()
    n_iters = 128
    fs_j = jfeat.fpfh_features(jnp.asarray(src), jnp.asarray(n_src), k=12)
    ft_j = jfeat.fpfh_features(jnp.asarray(tgt), jnp.asarray(n_tgt), k=12)
    Rj, tj, inl_j = jfeat.ransac_align(jnp.asarray(src), fs_j, jnp.asarray(tgt), ft_j,
                                       n_iters=n_iters, inlier_dist=3.0)

    def jax_draw(probs, n, generator=None):
        p = jnp.asarray(_np(probs))
        keys = jax.random.split(jax.random.PRNGKey(0), n)
        sel = jax.vmap(lambda k: jax.random.choice(k, p.shape[0], shape=(3,), p=p))(keys)
        return torch.from_numpy(np.asarray(sel, np.int64))

    monkeypatch.setattr(tfeat, "_draw_hypotheses", jax_draw)
    Rt, tt, inl_t = tfeat.ransac_align(_t(src), _t(np.asarray(fs_j)), _t(tgt),
                                       _t(np.asarray(ft_j)), n_iters=n_iters,
                                       inlier_dist=3.0)
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(_np(tt), np.asarray(tj), atol=2e-2)
    # the similarity matmul rounds in another order: a match may flip
    assert abs(float(inl_t) - float(inl_j)) < 1e-2
    rot_err = np.degrees(np.arccos(np.clip((np.trace(_np(Rt).T @ R_true) - 1) / 2, -1, 1)))
    assert rot_err < 5.0 and np.linalg.norm(_np(tt) - t_true) < 10.0


@pytest.mark.parametrize("m,zeros", [(300, (5, 77)), (1280 * 1024, ())])
def test_draw_categorical_is_reproducible_and_keeps_the_distribution(m, zeros):
    """The port's categorical draw (``_draw_samples``, ``_draw_hypotheses``):
    the same bits from the same generator state; zero weights never drawn;
    the frequencies within 5 standard errors of p in every category, and of
    ``torch.multinomial``'s (the draw it replaces). At the 1.3 M-pixel size
    of ``_subsample``'s 0/1 weights, the draw covers the valid pixels
    uniformly (each category's count within 5 standard errors)."""
    rng = np.random.default_rng(21)
    n = 200_000
    if m <= 1000:
        p = torch.from_numpy(rng.random(m).astype(np.float32) ** 3)
    else:
        p = torch.from_numpy((rng.random(m) < 0.5).astype(np.float32))
    p[list(zeros)] = 0.0

    def gen():
        return torch.Generator().manual_seed(4)

    a, b = tfeat.draw_categorical(p, n, gen()), tfeat.draw_categorical(p, n, gen())
    assert a.dtype == torch.int64 and torch.equal(a, b)
    assert not bool((p[a] == 0).any())
    q = (p.double() / p.double().sum()).numpy()
    sigma = np.sqrt(q * (1 - q) / n) + 1e-12
    f_new = np.bincount(a.numpy(), minlength=m) / n
    if m <= 1000:
        f_old = np.bincount(torch.multinomial(p, n, replacement=True, generator=gen()).numpy(),
                            minlength=m) / n
        assert np.all(np.abs(f_new - q) <= 5 * sigma)
        assert np.all(np.abs(f_new - f_old) <= 5 * np.sqrt(2) * sigma)
    else:
        # ~655k valid pixels: per-pixel counts are Poisson(0.3); the share
        # drawn among valid pixels, and none outside
        valid = q > 0
        assert abs(f_new[valid].sum() - 1.0) < 1e-12
        hits = np.bincount(a.numpy(), minlength=m)[valid]
        lam = n / valid.sum()
        assert abs(hits.mean() - lam) < 1e-9 and abs(hits.var() - lam) < 5 * lam * np.sqrt(
            2.0 / valid.sum()) + 0.01
    # the two draws of the registration path, twice from the same seed
    assert torch.equal(tfeat._draw_hypotheses(p / p.sum(), 64, gen()),
                       tfeat._draw_hypotheses(p / p.sum(), 64, gen()))


def test_ransac_own_draw_recovers_motion():
    src, n_src, tgt, n_tgt, R_true, t_true = _feature_pair()
    fs = tfeat.fpfh_features(_t(src), _t(n_src), k=12)
    ft = tfeat.fpfh_features(_t(tgt), _t(n_tgt), k=12)
    R, t, inl = tfeat.ransac_align(_t(src), fs, _t(tgt), ft, n_iters=256,
                                   inlier_dist=3.0,
                                   generator=torch.Generator().manual_seed(1))
    rot_err = np.degrees(np.arccos(np.clip((np.trace(_np(R).T @ R_true) - 1) / 2, -1, 1)))
    assert rot_err < 5.0 and np.linalg.norm(_np(t) - t_true) < 10.0
    assert float(inl) > 0.1


# ---------------------------------------------------------------- pose graph

def test_pose_graph_matches_reference():
    rng = np.random.default_rng(5)
    S = 6
    R_true, t_true = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    for _ in range(1, S):
        Rr, tr = rotation(rng.uniform(-0.2, 0.2, 3)), rng.uniform(-20, 20, 3)
        R_true.append((R_true[-1] @ Rr).astype(np.float32))
        t_true.append((R_true[-2] @ tr + t_true[-1]).astype(np.float32))
    edges = [(s, s + 1) for s in range(S - 1)] + [(S - 1, 0), (0, 2)]
    Zr, Zt = [], []
    for i, j in edges:
        Rz = R_true[i].T @ R_true[j]
        tz = R_true[i].T @ (t_true[j] - t_true[i])
        Zr.append((Rz @ rotation(rng.normal(0, 0.002, 3))).astype(np.float32))
        Zt.append((tz + rng.normal(0, 0.05, 3)).astype(np.float32))
    R0, t0 = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    for s in range(S - 1):
        R0.append((R0[-1] @ Zr[s]).astype(np.float32))
        t0.append((R0[-2] @ Zt[s] + t0[-1]).astype(np.float32))
    args = [np.stack(R0), np.stack(t0), np.array([e[0] for e in edges]),
            np.array([e[1] for e in edges]), np.stack(Zr), np.stack(Zt)]
    rj = jpg.pose_graph_optimize(*(jnp.asarray(a) for a in args), iters=10)
    rt = tpg.pose_graph_optimize(*(torch.from_numpy(a) for a in args), iters=10)
    np.testing.assert_allclose(_np(rt.R), np.asarray(rj.R), atol=1e-5)
    np.testing.assert_allclose(_np(rt.t), np.asarray(rj.t), atol=1e-3)
    np.testing.assert_allclose(float(rt.rms), float(rj.rms), rtol=1e-3)
    assert float(rt.rms) < 1.0
    assert np.max(np.linalg.norm(_np(rt.t) - np.stack(t_true), axis=1)) < 1.0


# the kernel's working memory in shared memory up to its 232,432 bytes, past
# them in a global-memory workspace, and shapes past its int32 offsets refused
_ROUTE = ([(S, E, "shared") for S in (2, 8, 32, 33) for E in (S - 1, 85, 86)]
          + [(1, 1, "shared"), (32, 207, "shared"), (32, 208, "workspace"),
             (8, 584, "shared"), (8, 585, "workspace"), (38, 37, "shared"),
             (39, 38, "workspace"), (48, 71, "workspace"), (1024, 1023, "workspace"),
             (0, 1, "refused"), (8, 0, "refused"), (1025, 1024, "refused"),
             (8, (1 << 20) + 1, "refused")])


@pytest.mark.parametrize("S,E,where", _ROUTE)
def test_pose_graph_route_at_its_edges(S, E, where):
    """Every graph on the card takes the kernel: in shared memory while its
    words fit, else on the workspace; no pose, no edge, or past the int32
    offsets, refused (12 E = 1,020 and 1,032 (edge, tangent) pairs at E = 85
    and 86: a block of 256 threads loops either way)."""
    if where == "refused":
        with pytest.raises(ValueError, match="the kernel takes"):
            kpg.check_shape(S, E)
        return
    kpg.check_shape(S, E)
    assert kpg.in_shared(S, E) == (where == "shared")
    assert (4 * kpg.words(S, E) <= kpg.SMEM_MAX) == (where == "shared")


def test_pose_graph_on_cpu_tensors_launches_nothing():
    """CPU tensors run the plain version whatever their shape, and count no
    launch."""
    args = pose_graph_case("cpu", 3, [(0, 1), (1, 2), (0, 2)], 5, 0.002, 0.05, 20.0)
    before = obs.snapshot().counts.get("launches.pose_graph", 0)
    got = tpg.pose_graph_optimize(*args, iters=2)
    want = tpg.pose_graph_optimize_reference(*args, iters=2)
    assert obs.snapshot().counts.get("launches.pose_graph", 0) == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_pose_graph_taylor_case_ends_in_the_taylor_branch():
    """The card tests' ``taylor_branch`` graph (exact measured rotations,
    2 mm steps): every final rotation residual lies below so3_log's
    |w|^2 = 1e-12, so its Taylor branch is what the kernel is held to."""
    case = POSE_GRAPH_CASES["taylor_branch"]
    args = pose_graph_case("cpu", *case["graph"])
    res = tpg.pose_graph_optimize(*args, **case["solve"])
    assert pose_graph_max_w2(res.R, res.t, args) < 1e-12
    assert 1e-3 < float(res.rms) < 1e-2


@pytest.mark.parametrize("name", list(POSE_GRAPH_CASES))
def test_pose_graph_cases_match_jax(name):
    """The plain version against JAX on every graph the card tests hold the
    kernel to, at the JAX parity test's tolerances: kernel, plain version
    and JAX agree on the same inputs."""
    case = POSE_GRAPH_CASES[name]
    args = pose_graph_case("cpu", *case["graph"])
    rj = jpg.pose_graph_optimize(*(jnp.asarray(a.numpy()) for a in args), **case["solve"])
    rt = tpg.pose_graph_optimize_reference(*args, **case["solve"])
    np.testing.assert_allclose(_np(rt.R), np.asarray(rj.R), atol=1e-5)
    np.testing.assert_allclose(_np(rt.t), np.asarray(rj.t), atol=1e-3)
    np.testing.assert_allclose(float(rt.rms), float(rj.rms), rtol=1e-3)
    assert float(rt.rms) > 1e-3    # above float32 rounding: the RMS says something
