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
from slr_torch.geom import camera as tcam
from slr_torch.geom import se3 as tse3
from slr_torch.kernels import band_nn as kband
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


def _bumpy(n, seed, half=100.0, base=500.0):
    """Points of the reference's bumpy surface z(x, y) and its unit normals."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-half, half, (n, 2))
    z = base + 20 * np.sin(xy[:, 0] / 25.0) * np.cos(xy[:, 1] / 30.0) \
        + 8 * np.sin(xy[:, 1] / 12.0)
    gx = 20 * np.cos(xy[:, 0] / 25.0) / 25.0 * np.cos(xy[:, 1] / 30.0)
    gy = (-20 * np.sin(xy[:, 0] / 25.0) * np.sin(xy[:, 1] / 30.0) / 30.0
          + 8 * np.cos(xy[:, 1] / 12.0) / 12.0)
    n0 = np.column_stack([-gx, -gy, np.ones_like(gx)])
    n0 /= np.linalg.norm(n0, axis=1, keepdims=True)
    return np.column_stack([xy, z]).astype(np.float32), n0.astype(np.float32)


def _rot(rv):
    return np.asarray(jse3.so3_exp(jnp.asarray(rv, jnp.float32)))


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

def _icp_case(n, seed):
    """Noisy (0.05 mm), so the Huber weights are not set by rounding; near
    the origin, so the expanded form's rounding (~eps |q|^2) rarely changes
    a nearest neighbour between the packages."""
    src, n0 = _bumpy(n, seed, base=0.0)
    R_true = _rot([0.01, -0.02, 0.015])
    t_true = np.array([3.0, -2.0, 4.0], np.float32)
    noise = np.random.default_rng(seed).normal(0, 0.05, src.shape)
    tgt = (src @ R_true.T + t_true + noise).astype(np.float32)
    return src, tgt, (n0 @ R_true.T).astype(np.float32), R_true, t_true


def test_icp_exact_route_matches_reference():
    src, tgt, n_tgt, R_true, t_true = _icp_case(1500, 7)
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
    src, tgt, n_tgt, R_true, t_true = _icp_case(2000, 8)
    rng = np.random.default_rng(3)
    tv = rng.random(len(tgt)) > 0.05
    sv = rng.random(len(src)) > 0.05
    R0 = _rot([0.005, -0.01, 0.01])
    t0 = np.array([2.0, -1.0, 3.0], np.float32)
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
    assert ticp._resolve_nn_method("auto", 4096, 4096) == "exact"
    assert ticp._resolve_nn_method("auto", 262144, 262144) == "band"
    assert ticp._resolve_nn_method("exact", 262144, 262144) == "exact"
    with pytest.raises(NotImplementedError, match="slice 6"):
        ticp._resolve_nn_method("voxel", 10, 10)
    with pytest.raises(ValueError):
        ticp._resolve_nn_method("kdtree", 10, 10)


def test_icp_projective_matches_reference():
    """Dense projective association on an organized grid, from a small
    offset pose."""
    H, W = 48, 64
    cj = jcam.make_camera(fx=70.0, fy=70.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    ct = tcam.make_camera(fx=70.0, fy=70.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5)
    v, u = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                       indexing="ij")
    x, y = (u - W / 2 + 0.5) / 70.0, (v - H / 2 + 0.5) / 70.0
    z = 500 + 25 * np.sin(x * 4) * np.cos(y * 5) + 10 * x
    grid = np.stack([x * z, y * z, z], -1).astype(np.float32)
    mask = np.ones((H, W), bool)
    mask[:3] = False
    n_grid = np.asarray(jnormals.grid_normals(jnp.asarray(grid), jnp.asarray(mask)))
    R_m, t_m = _rot([0.004, -0.006, 0.003]), np.array([1.0, -0.8, 1.5], np.float32)
    rng = np.random.default_rng(0)
    sel = rng.choice(H * W, 800, replace=False)
    # source points: target surface points seen from the moved rig
    src = ((grid.reshape(-1, 3)[sel] - t_m) @ R_m).astype(np.float32)
    sv = mask.reshape(-1)[sel]
    rj = jproj.icp_projective(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(grid),
                              jnp.asarray(mask), jnp.asarray(n_grid), cj, iters=10,
                              max_corr_dist=10.0)
    rt = tproj.icp_projective(_t(src), torch.from_numpy(sv), _t(grid),
                              torch.from_numpy(mask), _t(n_grid), ct, iters=10,
                              max_corr_dist=10.0)
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
    src, n_src = _bumpy(700, 3, half=60.0, base=0.0)
    src = np.round(src * 16) / 16
    R_true = _rot([0.05, 0.1, 0.4])
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
    R = np.stack([_rot(rng.normal(size=3)) for _ in range(5)])
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
        Rr, tr = _rot(rng.uniform(-0.2, 0.2, 3)), rng.uniform(-20, 20, 3)
        R_true.append((R_true[-1] @ Rr).astype(np.float32))
        t_true.append((R_true[-2] @ tr + t_true[-1]).astype(np.float32))
    edges = [(s, s + 1) for s in range(S - 1)] + [(S - 1, 0), (0, 2)]
    Zr, Zt = [], []
    for i, j in edges:
        Rz = R_true[i].T @ R_true[j]
        tz = R_true[i].T @ (t_true[j] - t_true[i])
        Zr.append((Rz @ _rot(rng.normal(0, 0.002, 3))).astype(np.float32))
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
