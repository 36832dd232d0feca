"""slr_torch.kernels.crossing: the plain versions of K6 and K7 against the
JAX reference (CPU: JAX's Pallas kernels in interpret mode) and against a
brute-force crossing search; and a numpy model of the kernels' bin phase
(per-bin pair ranges from integer min/max, then an ascending walk) against
both plain routes on adversarial rows.

Tolerances: the crossing counts exactly. The interpolated channels 1e-4
(both packages round ``lo - cl * g`` and ``A + k * B`` once, as XLA's FMAs
on the CPU; where a bin has several crossings the sums' order differs). The
nearest channels 1e-6 against JAX's fused route, which keeps them float32,
and 0.3 against JAX's unfused oracle, which stores them in bf16 (its step
at |q| ~ 50 is 0.25).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slr.kernels import crossing as jx
from slr_torch.kernels import crossing as tx

torch.set_num_threads(2)

INTERP = (True, True, False, False)


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _random_case(R, U, seed=3, wiggle=0.0, dead_rows=()):
    """The reference's random case (``tests/test_twocam.py:316-322``):
    increasing codes, 5 % invalid pixels, four channels ~ N(50, 10); with
    ``wiggle`` > 0, codes with noise that makes bins cross several times;
    ``dead_rows`` have no valid pixel."""
    rng = np.random.default_rng(seed)
    code = np.cumsum(rng.uniform(0.2, 1.4, (R, U)), axis=1)
    code = code - code[:, :1] + rng.uniform(-3, 3, (R, 1))
    code = (code + wiggle * rng.normal(size=(R, U))).astype(np.float32)
    valid = rng.random((R, U)) > 0.05
    valid[list(dead_rows)] = False
    ch_q = (rng.normal(0, 1, (4, R, U)) * 10 + 50).astype(np.float32)
    return code, valid, ch_q


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _compare(cnt, vals, cnt_j, vals_j, nearest_tol):
    np.testing.assert_array_equal(_np(cnt), _np(cnt_j))
    for c in range(len(INTERP)):
        tol = 1e-4 if INTERP[c] else nearest_tol
        np.testing.assert_allclose(_np(vals[c]), _np(vals_j[c]), rtol=0, atol=tol)


@pytest.mark.parametrize("route", ["plain", "dispatch", "fused"])
def test_crossings_match_brute_force(route):
    """``tests/test_kernels.py:306-353``: a shadow gap and a 30-bin
    occlusion jump; every crossing found, its position within 1e-3 px."""
    rng = np.random.default_rng(0)
    R, U, K = 16, 256, 128
    base = np.cumsum(rng.uniform(0.4, 1.2, (R, U)), axis=1) * 0.55
    base += rng.normal(0, 0.01, (R, U))
    code = base.astype(np.float32)
    valid = np.ones((R, U), bool)
    valid[:, 60:80] = False                 # shadow gap
    code[:, 160:] += 30.0                   # 30-bin occlusion jump
    chan_u = np.broadcast_to(np.arange(U, dtype=np.float32), (R, U)).copy()
    chan_q = rng.uniform(0.5, 1.0, (R, U)).astype(np.float32)
    code_t, valid_t, ch_t = _torch(code, valid, np.stack([chan_u, chan_q]))
    if route == "fused":
        cnt, vals = tx.crossing_interp_fused(code_t, valid_t, ch_t, K, (True, False))
    else:
        cnt, vals = tx.crossing_interp(code_t, valid_t, ch_t, K, (True, False),
                                       use_kernel=route == "dispatch")
    cnt, vals = _np(cnt), _np(vals)
    n_checked = 0
    for r in range(0, R, 3):
        for k in range(K):
            xs = []
            for u in range(U - 1):
                if not (valid[r, u] and valid[r, u + 1]):
                    continue
                d = code[r, u + 1] - code[r, u]
                if not (0.125 < d < 4.0):
                    continue
                if code[r, u] <= k < code[r, u + 1]:
                    xs.append(u + (k - code[r, u]) / d)
            assert len(xs) == cnt[r, k], (r, k, len(xs), cnt[r, k])
            if xs:
                assert abs(np.mean(xs) - vals[0, r, k]) < 1e-3
                n_checked += 1
    assert n_checked > 200
    # and against JAX's own routes on the same case
    cnt_j, vals_j = jx.crossing_interp(jnp.asarray(code), jnp.asarray(valid),
                                       jnp.stack([jnp.asarray(chan_u), jnp.asarray(chan_q)]),
                                       K, interp=(True, False), use_kernel=False)
    np.testing.assert_array_equal(cnt, np.asarray(cnt_j))
    np.testing.assert_allclose(vals[0], np.asarray(vals_j[0]), rtol=0, atol=1e-4)


def test_random_case_matches_reference_routes():
    """The reference's own case (``tests/test_twocam.py:308-336``) through
    both of JAX's routes: the fused kernel (interpret mode) and the
    unfused oracle with ``pair_gate``."""
    code, valid, ch_q = _random_case(24, 700)
    K = 520
    gate = np.abs(ch_q[1][:, 1:] - ch_q[1][:, :-1]) < 3.0
    code_t, valid_t, ch_t, gate_t = _torch(code, valid, ch_q, gate)
    cnt, vals = tx.crossing_interp_fused(code_t, valid_t, ch_t, K, INTERP, gates=((1, 3.0),))
    cnt_f, vals_f = jx.crossing_interp_fused(jnp.asarray(code), jnp.asarray(valid),
                                             jnp.asarray(ch_q), K, interp=INTERP,
                                             gates=((1, 3.0),))
    cnt_o, vals_o = jx.crossing_interp(jnp.asarray(code), jnp.asarray(valid),
                                       jnp.asarray(ch_q), K, interp=INTERP,
                                       use_kernel=False, pair_gate=jnp.asarray(gate))
    assert float(cnt.sum()) > 1000       # the gate keeps ~1 pair in 6
    _compare(cnt, vals, cnt_f, vals_f, nearest_tol=1e-6)
    _compare(cnt, vals, cnt_o, vals_o, nearest_tol=0.3)
    # the port's two routes: K7's plain version is crossing_interp's plain
    # route with the gate as its pair veto, bit for bit
    cnt2, vals2 = tx.crossing_interp(code_t, valid_t, ch_t, K, INTERP, use_kernel=False,
                                     pair_gate=gate_t)
    assert torch.equal(cnt, cnt2) and torch.equal(vals, vals2)


@pytest.mark.parametrize("R,U,K,wiggle,dead", [
    (37, 333, 200, 0.0, ()),           # ragged: nothing a multiple of anything
    (9, 64, 150, 0.3, (2, 5)),          # K > U, noisy wiggles, rows with no pair
    (5, 2, 7, 0.0, ()),                 # one pair a row
    (12, 97, 31, 0.6, (0,)),            # bins far fewer than pairs
])
def test_ragged_shapes_match_reference(R, U, K, wiggle, dead):
    code, valid, ch_q = _random_case(R, U, seed=R + U, wiggle=wiggle, dead_rows=dead)
    code_t, valid_t, ch_t = _torch(code, valid, ch_q)
    gates = ((1, 25.0), (3, 30.0))
    cnt, vals = tx.crossing_interp_fused(code_t, valid_t, ch_t, K, INTERP, gates=gates)
    cnt_j, vals_j = jx.crossing_interp_fused(jnp.asarray(code), jnp.asarray(valid),
                                             jnp.asarray(ch_q), K, interp=INTERP,
                                             gates=gates)
    assert cnt.shape == (R, K) and vals.shape == (4, R, K)
    _compare(cnt, vals, cnt_j, vals_j, nearest_tol=1e-6)
    for r in dead:
        assert float(cnt[r].abs().max()) == 0.0 and float(vals[:, r].abs().max()) == 0.0
    if wiggle:
        assert float(cnt.max()) >= 2.0      # bins crossed more than once


def test_bin_sum_matches_reference_contraction():
    """K6's plain version against JAX's Pallas kernel (interpret mode) and
    its oracle on a payload JAX's kernel takes exactly (bf16 values);
    invalid pairs arrive with lo == hi == -1 and zero payload."""
    rng = np.random.default_rng(7)
    R, U, N, K = 10, 150, 5, 97
    lo = np.cumsum(rng.uniform(0.2, 1.6, (R, U)), axis=1).astype(np.float32) - 5.0
    hi = lo + rng.uniform(0.1, 2.4, (R, U)).astype(np.float32)
    dead = rng.random((R, U)) < 0.1
    lo[dead] = hi[dead] = -1.0
    pay = rng.normal(0, 3, (R, N, U)).astype(np.float32)
    pay = np.array(jnp.asarray(pay).astype(jnp.bfloat16).astype(jnp.float32))
    pay[np.broadcast_to(dead[:, None, :], pay.shape)] = 0.0
    lo_t, hi_t, pay_t = _torch(lo, hi, pay)
    out = tx.crossing_bin_sum(lo_t, hi_t, pay_t, K)
    assert out.shape == (R, N, K) and out.dtype == torch.float32
    ref = jx.crossing_bin_sum_reference(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(pay), K)
    ker = jx.crossing_bin_sum(jnp.asarray(lo), jnp.asarray(hi),
                              jnp.asarray(pay).astype(jnp.bfloat16), K)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(out), np.asarray(ker), rtol=0, atol=1e-5)
    # a bin's sum is the payload of the pairs that cross it, counted directly
    r, k = 3, 40
    fire = (lo[r] <= k) & (hi[r] > k)
    np.testing.assert_allclose(_np(out[r, :, k]), pay[r][:, fire].sum(axis=1), atol=1e-5)


def test_payload_is_float32_with_seven_terms():
    """The port's payload: count, (a, g) per interpolated channel, one term
    per nearest channel, in float32 with no padding: N = 7 for the merge's
    layout (the reference's TPU layout has 16)."""
    code, valid, ch_q = _random_case(4, 30)
    code_t, valid_t, ch_t = _torch(code, valid, ch_q)
    cl, ch = code_t[:, :-1], code_t[:, 1:]
    pv = valid_t[:, :-1] & valid_t[:, 1:]
    payload, unpack = tx.build_payload(pv, cl, ch_t[:, :, :-1], ch_t[:, :, 1:], ch - cl,
                                       INTERP)
    assert payload.shape == (4, 7, 29) and payload.dtype == torch.float32
    assert torch.equal(payload[:, 0], pv.float())
    assert float(payload[:, :, :][~pv[:, None, :].expand_as(payload)].abs().max()) == 0.0
    cnt, vals = unpack(torch.zeros((4, 7, 11)), torch.arange(11.0)[None, :])
    assert len(vals) == 4 and float(cnt.abs().max()) == 0.0


def test_wrappers_take_the_plain_version_on_cpu():
    """A CPU tensor never reaches a kernel: no launch is counted, and the
    reference's tiling knobs change nothing."""
    code, valid, ch_q = _random_case(6, 80, seed=11)
    code_t, valid_t, ch_t = _torch(code, valid, ch_q)
    before = (tx.crossing_bin_sum.launches, tx.crossing_interp_fused.launches)
    a = tx.crossing_interp_fused(code_t, valid_t, ch_t, 60, INTERP, gates=((1, 20.0),), rt=3)
    b = tx.crossing_interp(code_t, valid_t, ch_t, 60, INTERP)
    lo, hi = code_t[:, :-1], code_t[:, 1:]
    pay = ch_t[:, :, :-1].permute(1, 0, 2).contiguous()
    c = tx.crossing_bin_sum(lo, hi, pay, 60, utile=128, rt=4, usub=64, ksub=32, ktile=16)
    assert torch.equal(c, tx.crossing_bin_sum_reference(lo, hi, pay, 60))
    assert (tx.crossing_bin_sum.launches, tx.crossing_interp_fused.launches) == before
    assert a[0].shape == b[0].shape == (6, 60)
    with pytest.raises(ValueError, match="CUDA"):
        tx.launch_interp_fused(code_t, valid_t, ch_t, 60, INTERP)
    with pytest.raises(ValueError, match="CUDA"):
        tx.launch_bin_sum(lo, hi, pay, 60)


# ------------------------------------------- the kernels' bin phase, modelled

INT_MAX = np.iinfo(np.int32).max


def _crossings(lo, hi, K):
    """Every crossing (pair u, bin k) of one row: lo[u] <= k < hi[u] for the
    integers k in [0, K), enumerated as the kernels' range build does (from
    max(0, ceil(lo)) while k < K and k < hi; NaN never fires)."""
    with np.errstate(invalid="ignore"):
        fire = np.flatnonzero(lo < hi)
    l64, h64 = lo[fire].astype(np.float64), hi[fire].astype(np.float64)
    k0 = np.where(l64 <= 0, 0.0, np.ceil(np.minimum(l64, K)))
    k1 = np.clip(np.ceil(np.minimum(h64, K)), 0, K)
    n = np.maximum(k1 - k0, 0).astype(np.int64)
    us = np.repeat(fire, n)
    ks = np.concatenate([np.arange(a, a + m) for a, m in zip(k0.astype(np.int64), n)]
                        + [np.zeros(0, np.int64)])
    return us, ks


def _range_walk(lo, hi, payload, K):
    """numpy model of K6's and K7's bin phase. Per row: first[k] and last[k],
    the least and greatest pair firing bin k (np.minimum.at / np.maximum.at
    over the crossings, order-free as the kernels' integer atomics); then
    each bin walks u = first[k] .. last[k] in ascending order and adds, in
    float32, the payload of the pairs that fire it. Returns (out (R, N, K),
    first, last, walked: {(r, k): the pairs summed, in order})."""
    R, U = lo.shape
    N = payload.shape[1]
    out = np.zeros((R, N, K), np.float32)
    first = np.full((R, K), INT_MAX, np.int64)
    last = np.full((R, K), -1, np.int64)
    walked = {}
    for r in range(R):
        us, ks = _crossings(lo[r], hi[r], K)
        np.minimum.at(first[r], ks, us)
        np.maximum.at(last[r], ks, us)
        for k in np.flatnonzero(last[r] >= 0):
            acc, seen = np.zeros(N, np.float32), []
            for u in range(first[r, k], last[r, k] + 1):
                if lo[r, u] <= np.float32(k) < hi[r, u]:
                    acc = acc + payload[r, :, u]
                    seen.append(u)
            out[r, :, k] = acc
            walked[(r, k)] = seen
    return out, first, last, walked


def _adversarial(kind, seed=0):
    """(code, valid, channels, K) of a K7-shaped adversarial case, or
    (lo, hi, payload, K) of a K6-shaped one (``span40``)."""
    rng = np.random.default_rng(seed)
    if kind == "span40":
        R, U, N, K = 9, 333, 5, 150
        lo = rng.uniform(-20, K + 5, (R, U)).astype(np.float32)
        hi = (lo + rng.uniform(30, 45, (R, U))).astype(np.float32)
        dead = rng.random((R, U)) < 0.1
        lo[dead] = hi[dead] = -1.0
        lo[0, :7] = [np.nan, -np.inf, 3.5, np.nan, -np.inf, 10.0, np.inf]
        hi[0, :7] = [5.0, 2.5, np.nan, np.nan, np.inf, np.inf, np.inf]
        pay = rng.normal(0, 3, (R, N, U)).astype(np.float32)
        pay[np.broadcast_to(dead[:, None, :], pay.shape)] = 0.0
        return lo, hi, pay, K
    R, U, K, wiggle, start = {"wiggle2": (12, 333, 260, 2.0, (-3, 3)),
                              "nan_inf": (9, 701, 520, 0.0, (-3, 3)),
                              "clipped": (10, 300, 120, 0.3, (-30, -5)),
                              "u700": (6, 700, 520, 0.5, (-3, 3))}[kind]
    code = np.cumsum(rng.uniform(0.2, 1.4, (R, U)), axis=1)
    code = code - code[:, :1] + rng.uniform(*start, (R, 1))
    code = (code + wiggle * rng.normal(size=(R, U))).astype(np.float32)
    if kind == "nan_inf":
        for value, share in ((np.nan, 0.03), (np.inf, 0.01), (-np.inf, 0.01)):
            code[rng.random((R, U)) < share] = value
    valid = rng.random((R, U)) > 0.05
    ch = (rng.normal(0, 1, (4, R, U)) * 10 + 50).astype(np.float32)
    return code, valid, ch, K


def _check_walk(lo, hi, pay, K, out, first, last, walked):
    """The invariant the kernels rely on: every pair that fires k lies in
    [first[k], last[k]], and the walk sums exactly those pairs, ascending;
    then the walk's sums against the port's plain contraction (bit-equal:
    it sums in the same ascending order) and JAX's reference contraction
    (1e-6 of the terms' magnitudes where a bin has several crossings)."""
    R = lo.shape[0]
    for r in range(R):
        us, ks = _crossings(lo[r], hi[r], K)
        for k in range(K):
            fire = np.sort(us[ks == k])
            if fire.size:
                assert first[r, k] <= fire[0] and fire[-1] <= last[r, k]
            assert walked.get((r, k), []) == fire.tolist()
            # the same pairs by a brute force over the whole row
            with np.errstate(invalid="ignore"):
                brute = np.flatnonzero((lo[r] <= k) & (k < hi[r]))
            assert brute.tolist() == fire.tolist()
    plain = _np(tx.crossing_bin_sum_reference(*_torch(lo, hi, pay), K))
    n_fire = np.zeros((R, K), np.int64)
    for (r, k), seen in walked.items():
        n_fire[r, k] = len(seen)
    np.testing.assert_array_equal(out, plain)
    # JAX's contraction sums in another order: where a bin has several
    # crossings the two orders of a float32 sum differ by a few roundings of
    # the terms' magnitudes (the a terms cancel): 1e-6 of the sum of |terms|
    scale = _np(tx.crossing_bin_sum_reference(*_torch(lo, hi, np.abs(pay)), K))
    ref = np.asarray(jx.crossing_bin_sum_reference(jnp.asarray(lo), jnp.asarray(hi),
                                                   jnp.asarray(pay), K))
    assert float((np.abs(out - ref) / np.maximum(scale, 1.0)).max()) <= 1e-6
    return n_fire


@pytest.mark.parametrize("kind", ["wiggle2", "nan_inf", "clipped", "u700"])
def test_range_walk_matches_plain_routes_on_rows(kind):
    """K7-shaped rows: the pairs (with a carried-channel gate) through the
    modelled bin phase equal both packages' plain routes."""
    code, valid, ch, K = _adversarial(kind, seed=len(kind))
    gates = ((1, 25.0),)
    code_t, valid_t, ch_t = _torch(code, valid, ch)
    gate = tx.gate_mask(ch_t, gates)
    lo, hi, pay, unpack = tx.crossing_pairs(code_t, valid_t, ch_t, INTERP, pair_gate=gate)
    lo, hi, pay = _np(lo), _np(hi), _np(pay)
    out, first, last, walked = _range_walk(lo, hi, pay, K)
    n_fire = _check_walk(lo, hi, pay, K, out, first, last, walked)
    kgrid = torch.arange(K, dtype=torch.float32)[None, :]
    cnt, vals = unpack(torch.from_numpy(out), kgrid)
    cnt_p, vals_p = tx.crossing_interp_fused_reference(code_t, valid_t, ch_t, K, INTERP, gates)
    assert torch.equal(cnt, cnt_p)
    vals, vals_p = _np(torch.stack(vals)), _np(vals_p)
    np.testing.assert_array_equal(vals, vals_p)
    # JAX's oracle: within 1e-6 of the value the terms' magnitudes would
    # give ((sum |a| + k sum |g|) / cnt), as the sums above
    abs_sums = tx.crossing_bin_sum_reference(*_torch(lo, hi, np.abs(pay)), K)
    scale = np.maximum(_np(torch.stack(unpack(abs_sums, kgrid)[1])), 1.0)
    cnt_j, vals_j = jx.crossing_interp(jnp.asarray(code), jnp.asarray(valid), jnp.asarray(ch),
                                       K, interp=INTERP, use_kernel=False,
                                       pair_gate=jnp.asarray(_np(gate)))
    np.testing.assert_array_equal(_np(cnt), np.asarray(cnt_j))
    vals_j = np.asarray(vals_j)
    for c in range(len(INTERP)):
        if INTERP[c]:
            assert float((np.abs(vals[c] - vals_j[c]) / scale[c]).max()) <= 1e-6
        else:   # JAX's oracle stores nearest channels in bf16
            np.testing.assert_allclose(vals[c], vals_j[c], rtol=0, atol=0.3)
    if kind == "wiggle2":
        assert n_fire.max() >= 4 and (last - first).max() >= 8    # long ranges
    if kind == "clipped":
        assert ((lo < 0) & (lo != -1.0)).any() and (hi > K).any()
    if kind == "nan_inf":
        assert np.isnan(code).any() and np.isinf(code).any() and cnt.sum() > 1000


def test_range_walk_matches_plain_routes_on_wide_spans():
    """K6-shaped pairs spanning 30-45 bins, clipped at both ends, with NaN
    and infinite codes: the modelled bin phase equals both packages'
    reference contractions."""
    lo, hi, pay, K = _adversarial("span40")
    out, first, last, walked = _range_walk(lo, hi, pay, K)
    n_fire = _check_walk(lo, hi, pay, K, out, first, last, walked)
    finite = np.isfinite(lo) & np.isfinite(hi) & (lo < hi)
    assert n_fire.max() >= 20 and (hi[finite] - lo[finite]).max() >= 40
