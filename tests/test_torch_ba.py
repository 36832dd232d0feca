"""slr_torch.dist.ba (the single-device Schur bundle adjustment) against the
JAX reference (CPU).

A shrunk copy of the reference's synthetic case (``tests/test_dist.py``):
S = 4 poses, L = 256 landmarks, K = 3 observations each, numpy-seeded, with
point rows and with point-to-plane rows, with and without Huber weights and
missing observations. Tolerances: both packages solve the same float32
normal equations (pose 0 anchored by 1e12 on its diagonal) whose sums run
in another order, so R within 1e-5, t within 1e-3, landmarks within 1e-3
(scene units ~100), cost and rms within 1e-3 relative; ``_inv3x3`` within
1e-6 relative (the same closed form).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr.dist import ba as jba
from slr.geom.se3 import so3_exp
from slr_torch.dist import ba as tba

torch.set_num_threads(2)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _problem(S=4, L=256, K=3, noise=0.01, seed=0, missing=0.0):
    """The reference's ``_make_ba_problem`` in numpy (its rotations by the
    reference's so3_exp), plus unit normals and dropped observations."""
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
    obs_w = (rng.random((L, K)) >= missing).astype(np.float32)
    n = rng.normal(size=(L, K, 3))
    obs_n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    R0 = np.stack([R_true[s] @ np.asarray(so3_exp(jnp.asarray(rng.normal(0, 0.02, 3),
                                                              jnp.float32)))
                   for s in range(S)]).astype(np.float32)
    t0 = (t_true + rng.normal(0, 1.0, (S, 3))).astype(np.float32)
    X0 = (X_true + rng.normal(0, 1.0, (L, 3))).astype(np.float32)
    R0[0], t0[0] = np.eye(3), 0.0
    return (R_true, t_true), (R0, t0, X0, obs_s, p, obs_w), obs_n


@pytest.mark.parametrize("rows,huber,missing", [("point", 0.0, 0.0), ("point", 1.0, 0.2),
                                                ("plane", 0.0, 0.0), ("plane", 1.0, 0.2)])
def test_bundle_adjust_reference_matches_reference(rows, huber, missing):
    (R_true, t_true), args, obs_n = _problem(missing=missing)
    if huber:
        # a few gross outliers for the Huber weights to bite on
        args[4][:8, 0] += 25.0
    nrm = obs_n if rows == "plane" else None
    j = jba.bundle_adjust_reference(*map(jnp.asarray, args), iters=8, huber_delta=huber,
                                    obs_n=None if nrm is None else jnp.asarray(nrm))
    t = tba.bundle_adjust_reference(*map(torch.from_numpy, args), iters=8,
                                    huber_delta=huber,
                                    obs_n=None if nrm is None else torch.from_numpy(nrm))
    np.testing.assert_allclose(_np(t.R), np.asarray(j.R), atol=1e-5)
    np.testing.assert_allclose(_np(t.t), np.asarray(j.t), atol=1e-3)
    np.testing.assert_allclose(_np(t.X), np.asarray(j.X), atol=1e-3)
    np.testing.assert_allclose(float(t.cost), float(j.cost), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(float(t.rms), float(j.rms), rtol=1e-3, atol=1e-7)
    # pose 0 stays anchored; the others converge toward the truth
    np.testing.assert_allclose(_np(t.t[0]), 0.0, atol=1e-4)
    if rows == "point" and not huber:
        np.testing.assert_allclose(_np(t.t), t_true, atol=0.2)


def test_bundle_adjust_reference_noiseless_converges():
    """The reference's own convergence case, shrunk: no noise, rms -> 0."""
    (R_true, t_true), args, _ = _problem(noise=0.0)
    res = tba.bundle_adjust_reference(*map(torch.from_numpy, args), iters=10)
    assert float(res.rms) < 1e-4, float(res.rms)
    np.testing.assert_allclose(_np(res.t), t_true, atol=0.05)
    np.testing.assert_allclose(_np(res.R), R_true, atol=1e-3)


def test_inv3x3_matches_reference():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    A[0] = 0.0                                  # singular: det clamped
    inv_t = _np(tba._inv3x3(torch.from_numpy(A)))
    np.testing.assert_allclose(inv_t, np.asarray(jba._inv3x3(jnp.asarray(A))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(inv_t[1:] @ A[1:], np.broadcast_to(np.eye(3), (63, 3, 3)),
                               atol=2e-3)
