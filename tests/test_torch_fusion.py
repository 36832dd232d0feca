"""slr_torch fusion utilities against the JAX reference (CPU):
``voxel_downsample`` and the outlier filters (``knn_mean_distance``,
``statistical_outlier_removal``, ``radius_outlier_removal``).

The same numpy-seeded clouds go through ``slr.registration`` and
``slr_torch.registration``. Tolerances, each with its reason:
- voxel_downsample: slots, valid flags and ``n_voxels`` equal; means within
  1e-5 relative (float32, a voxel's points summed in index order by both, a
  mean of up to a few hundred points), and against a float64 numpy model of
  the same contract within 1e-4 relative;
- knn_mean_distance: within 1e-5 relative (float32 distances, the same k
  summed in the same ascending order);
- the two removals: the kept masks equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr.registration import filters as jfilt
from slr.registration import voxel as jvox
from slr_torch.registration import filters as tfilt
from slr_torch.registration import voxel as tvox

torch.set_num_threads(2)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _numpy_downsample(pts, valid, vs, capacity, attrs):
    """float64 model: voxels ordered by packed id in the window at the
    valid points' minimum voxel; means of each voxel's points."""
    v = np.floor(pts / np.float32(vs)).astype(np.int64)
    lo = v[valid].min(axis=0)
    w = v - lo
    inr = valid & np.all((w >= 0) & (w < 1024), axis=1)
    vid = w[:, 0] | (w[:, 1] << 10) | (w[:, 2] << 20)
    ids = np.unique(vid[inr])
    n = len(ids)
    out = np.zeros((capacity, 3))
    out_a = np.zeros((capacity, attrs.shape[1]))
    for k, i in enumerate(ids[:capacity]):
        sel = inr & (vid == i)
        out[k] = pts[sel].astype(np.float64).mean(axis=0)
        out_a[k] = attrs[sel].astype(np.float64).mean(axis=0)
    return out, np.arange(capacity) < n, out_a, n


def _cloud(case):
    rng = np.random.default_rng(7)
    if case == "ties":
        # 600 points in 20 voxels: many points a voxel
        pts = rng.integers(0, 3, (600, 3)).astype(np.float32) * 2.0 + rng.uniform(
            0.1, 1.9, (600, 3)).astype(np.float32)
        valid = np.ones(600, bool)
    else:
        pts = rng.normal(0.0, 30.0, (2000, 3)).astype(np.float32) + 500.0
        valid = rng.random(2000) > 0.2
        if case == "window":
            # beyond 1024 voxels of the minimum: dropped, never aliased
            pts[:40] += np.float32(1024 * 2.0 + 50.0)
    return pts, valid, rng.random((len(pts), 1)).astype(np.float32)


@pytest.mark.parametrize("case,capacity", [("masked", 4096), ("ties", 64),
                                           ("window", 4096), ("overflow", 700)])
def test_voxel_downsample_matches_reference(case, capacity):
    pts, valid, attrs = _cloud(case)
    vs = 2.0
    jp, jv, ja, jn = jvox.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid), vs,
                                           capacity=capacity, attrs=jnp.asarray(attrs))
    tp, tv, ta, tn = tvox.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(valid),
                                           vs, capacity=capacity,
                                           attrs=torch.from_numpy(attrs))
    assert tuple(tp.shape) == (capacity, 3) and tuple(ta.shape) == (capacity, 1)
    assert int(tn) == int(jn)
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), rtol=1e-5, atol=1e-6)
    mp, mv, ma, mn = _numpy_downsample(pts, valid, vs, capacity, attrs)
    assert int(tn) == mn
    if case == "overflow":
        assert mn > capacity            # voxels past capacity counted, dropped
    if case == "ties":
        assert mn < 60                  # many points in each voxel
    np.testing.assert_array_equal(_np(tv), mv)
    np.testing.assert_allclose(_np(tp), mp, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(ta), ma, rtol=1e-4, atol=1e-5)


def test_voxel_downsample_without_attrs():
    pts, valid, _ = _cloud("masked")
    tp, tv, ta, tn = tvox.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(valid),
                                           3.0, capacity=4096)
    jp, jv, _, jn = jvox.voxel_downsample(jnp.asarray(pts), jnp.asarray(valid), 3.0,
                                          capacity=4096)
    assert ta is None and int(tn) == int(jn)
    np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=1e-5, atol=1e-5)


def _uniform(n, hi, seed):
    return np.random.default_rng(seed).uniform(0, hi, (n, 3)).astype(np.float32)


def test_knn_mean_distance_matches_reference():
    """The reference's scipy case (tests/test_registration.py): 800 points,
    k = 6, voxel 8, buckets of 32; here a fifth of them masked."""
    pts = _uniform(800, 50, 11)
    valid = np.random.default_rng(1).random(800) > 0.2
    md_j = np.asarray(jfilt.knn_mean_distance(jnp.asarray(pts), jnp.asarray(valid), 8.0,
                                              k=6, chunk=256, bucket_cap=32))
    md_t = _np(tfilt.knn_mean_distance(torch.from_numpy(pts), torch.from_numpy(valid),
                                       8.0, k=6, chunk=256, bucket_cap=32))
    assert np.array_equal(np.isfinite(md_t), np.isfinite(md_j))
    assert not np.isfinite(md_t[~valid]).any()
    f = np.isfinite(md_j)
    np.testing.assert_allclose(md_t[f], md_j[f], rtol=1e-5)


@pytest.mark.parametrize("case", ["plants", "masked"])
def test_statistical_outlier_removal_matches_reference(case):
    rng = np.random.default_rng(12)
    if case == "plants":
        # the reference's jittered plane patch and 20 far-flung outliers
        g = np.linspace(0, 40, 40)
        xx, yy = np.meshgrid(g, g)
        plane = np.stack([xx + 0.25 * rng.normal(size=xx.shape),
                          yy + 0.25 * rng.normal(size=xx.shape),
                          0.02 * rng.normal(size=xx.shape)], -1).reshape(-1, 3)
        outl = rng.uniform(-200, 200, (20, 3))
        outl[:, 2] += 500.0
        pts = np.concatenate([plane, outl]).astype(np.float32)
        valid = np.ones(len(pts), bool)
        args = dict(voxel_size=4.0, k=6, std_ratio=2.0, chunk=512)
    else:
        pts = _uniform(300, 10, 14)
        valid = rng.uniform(size=300) > 0.3
        args = dict(voxel_size=5.0, k=4, chunk=128)
    keep_j = np.asarray(jfilt.statistical_outlier_removal(jnp.asarray(pts),
                                                          jnp.asarray(valid), **args))
    keep_t = _np(tfilt.statistical_outlier_removal(torch.from_numpy(pts),
                                                   torch.from_numpy(valid), **args))
    np.testing.assert_array_equal(keep_t, keep_j)
    assert not np.any(keep_t & ~valid)
    if case == "plants":
        assert keep_t[:1600].mean() > 0.93 and keep_t[1600:].sum() == 0


def test_radius_outlier_removal_matches_reference():
    pts = _uniform(600, 30, 13)
    valid = np.random.default_rng(2).random(600) > 0.1
    keep_j = np.asarray(jfilt.radius_outlier_removal(jnp.asarray(pts), jnp.asarray(valid),
                                                     3.0, min_neighbors=5, chunk=256))
    keep_t = _np(tfilt.radius_outlier_removal(torch.from_numpy(pts),
                                              torch.from_numpy(valid), 3.0,
                                              min_neighbors=5, chunk=256))
    np.testing.assert_array_equal(keep_t, keep_j)
    # against a brute-force count over the valid points
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    cnt = ((d <= 3.0) & valid[None]).sum(1) - 1
    np.testing.assert_array_equal(keep_t, valid & (cnt >= 5))
