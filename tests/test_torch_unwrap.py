"""slr_torch's spatial phase repair against the JAX reference (CPU).

The voting sweep (``propagation_step``, ``spatial_quality_unwrap``) and the
wavefront (``quality_guided_unwrap``, ``quality_guided_repair``) of
``slr_torch.codec.unwrap``, which are also the plain versions of the CUDA
kernels K3/K4 and K5, against ``slr.codec.unwrap`` and against the Pallas
kernels run as the JAX tests run them on the CPU (interpret mode). On a CPU
tensor the port's kernel wrappers take those plain versions.

Tolerances: the voting path within 1e-5 of JAX (XLA may contract
Phi + 2pi k into one FMA and divide by 2pi as a product with its
reciprocal; the port rounds twice and divides); the wavefront within
1e-4 rad (the reference scans a 4-field monoid, the port the 3-field one
of the TPU kernel) with equal reached maps. The port's own routes agree
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import corner_fronts, cu_constant
from slr.codec import unwrap as ju
from slr.kernels.unwrap_scan import quality_unwrap_pallas, quality_unwrap_tiled
from slr.kernels.wavefront import wavefront_repair_pallas
from slr_torch import observability as obs
from slr_torch.codec import unwrap as tu
from slr_torch.kernels import unwrap_scan as tus
from slr_torch.kernels import wavefront as twf
from slr_torch.pipeline.reconstruct import spatial_repair

torch.set_num_threads(2)


def _launches(*kernels):
    """The launches so far of each kernel ("k1" .. "k8"), from the
    recorder's ``launches.*`` counters; of one kernel, a number."""
    counts = obs.snapshot().counts
    got = tuple(counts.get(f"launches.{k}", 0) for k in kernels)
    return got[0] if len(got) == 1 else got


def _voting_map(partial: bool):
    """The reference's voting test map (tests/test_kernels.py:151-165):
    64x96, a gentle ramp with noise, 30 isolated pixels off by 3 fringe
    orders. ``partial``: a mask with holes, the bad pixels also on the
    borders and next to masked pixels."""
    rng = np.random.default_rng(0)
    H, W = 64, 96
    Phi = np.linspace(0, 30, W)[None, :] + 0.1 * rng.normal(size=(H, W))
    bad = np.zeros((H, W), bool)
    bad[rng.integers(1, H - 1, 30), rng.integers(1, W - 1, 30)] = True
    mask = np.ones((H, W), bool)
    if partial:
        mask = rng.random((H, W)) > 0.12
        mask[:, 80:] = False
        bad[0, 5:60:9] = bad[H - 1, 3:70:11] = True
        bad[7:50:8, 0] = bad[4:60:7, 79] = True
    q = np.where(bad, 0.05, 1.0).astype(np.float32)
    Phi_n = np.where(bad, Phi + 2 * np.pi * 3, Phi).astype(np.float32)
    return Phi.astype(np.float32), Phi_n, q, mask, bad


def _blob_map():
    """The reference's wavefront test map (tests/test_kernels.py:356-368):
    96x160, 60 isolated bad pixels and a 6x8 order-error blob."""
    rng = np.random.default_rng(3)
    H, W = 96, 160
    Phi = np.linspace(0, 40, W)[None, :] + 0.1 * rng.normal(size=(H, W))
    bad = np.zeros((H, W), bool)
    bad[rng.integers(1, H - 1, 60), rng.integers(1, W - 1, 60)] = True
    bad[30:36, 40:48] = True
    q = np.where(bad, 0.05, 1.0).astype(np.float32)
    Phi_n = np.where(bad, Phi + 2 * np.pi * 3, Phi).astype(np.float32)
    return Phi, Phi_n, q, np.ones((H, W), bool)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dy,dx", [(1, 0), (-1, 0), (0, 1), (0, -1)])
def test_shift_zero_matches_reference(dy, dx):
    a = np.random.default_rng(1).normal(size=(7, 9)).astype(np.float32)
    np.testing.assert_array_equal(tu._shift_zero(torch.from_numpy(a), dy, dx).numpy(),
                                  np.asarray(ju._shift_zero(jnp.asarray(a), dy, dx)))


@pytest.mark.parametrize("partial", [False, True], ids=["full", "partial"])
def test_propagation_step_matches_reference(partial):
    _, Phi_n, q, mask, _ = _voting_map(partial)
    (pj, qj, mj), (pt, qt, mt) = _both(Phi_n, q, mask)
    oj, _ = ju.propagation_step(pj, qj, mj)
    ot, q_out = tu.propagation_step(pt, qt, mt)
    assert q_out is qt and ot.dtype == torch.float32
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-5)
    assert (ot.numpy() != Phi_n).sum() == (np.asarray(oj) != Phi_n).sum() > 0


@pytest.mark.parametrize("partial", [False, True], ids=["full", "partial"])
def test_spatial_quality_unwrap_matches_reference(partial):
    Phi, Phi_n, q, mask, bad = _voting_map(partial)
    (pj, qj, mj), (pt, qt, mt) = _both(Phi_n, q, mask)
    ref = np.asarray(ju.spatial_quality_unwrap(pj, qj, mj, iters=6))
    out = tu.spatial_quality_unwrap(pt, qt, mt, iters=6).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # unmasked pixels never move; the interior isolated errors are repaired
    np.testing.assert_array_equal(out[~mask], Phi_n[~mask])
    if not partial:
        assert np.abs(out - Phi)[bad].max() < 1e-3


@pytest.mark.parametrize("partial", [False, True], ids=["full", "partial"])
def test_voting_matches_pallas_kernels(partial):
    """The JAX kernels K3 and K4 (interpret mode) against the port's
    wrappers, which take the plain version on the CPU: all one result."""
    _, Phi_n, q, mask, _ = _voting_map(partial)
    (pj, qj, mj), (pt, qt, mt) = _both(Phi_n, q, mask)
    k3 = np.asarray(quality_unwrap_pallas(pj, qj, mj, iters=6))
    k4 = np.asarray(quality_unwrap_tiled(pj, qj, mj, iters=6, tile_h=16))
    plain = tu.spatial_quality_unwrap(pt, qt, mt, iters=6)
    before = _launches("k3", "k4")
    for out in (tus.quality_unwrap(pt, qt, mt, iters=6),
                tus.quality_unwrap_tiled(pt, qt, mt, iters=6, halo=4)):
        assert torch.equal(out, plain)
    assert _launches("k3", "k4") == before
    for ref in (k3, k4):
        np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=1e-5)


def _tie_values(a, quotients=(0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5)):
    """float32 values y near a + q 2pi whose difference from a, divided by
    2pi in float32, is exactly q: the ties that round half to even breaks
    (0.5 -> 0, 1.5 -> 2, 2.5 -> 2). Some q have no such y near a."""
    tp, a = np.float32(2 * np.pi), np.float32(a)
    out = []
    for q in quotients:
        y0 = np.array([a + np.float32(q) * tp], np.float32)
        cands = (y0.view(np.int32) + np.arange(-64, 65, dtype=np.int32)).view(np.float32)
        out += list(cands[(cands - a) / tp == np.float32(q)][:1])
    return np.array(out, np.float32)


def _edge_vote_map(kind: str):
    """(Phi, mask) for the edge-vote model: ``holes`` (the voting map with
    a holed mask), ``ties`` (a checkerboard of a and values a tie away from
    a), ``zeros`` (+-0, +-2pi, denormals), ``large`` (|Phi| ~ 1e6 with
    order errors)."""
    rng = np.random.default_rng({"holes": 0, "ties": 1, "zeros": 2, "large": 3}[kind])
    H, W = 40, 56
    mask = rng.random((H, W)) > 0.15
    if kind == "holes":
        _, Phi, _, mask, _ = _voting_map(True)
    elif kind == "ties":
        Phi = np.zeros((H, W), np.float32)
        for cols, a in ((slice(0, W // 2), 0.0), (slice(W // 2, W), 1.25)):
            ties = _tie_values(a)
            assert len(ties) >= 4
            odd = rng.choice(ties, size=(H, W // 2))
            even = (np.add.outer(np.arange(H), np.arange(W // 2)) % 2) == 0
            Phi[:, cols] = np.where(even, np.float32(a), odd)
    elif kind == "zeros":
        Phi = rng.choice(np.float32([0.0, -0.0, 2 * np.pi, -2 * np.pi, 4 * np.pi,
                                     1e-40, -1e-40, np.pi]), size=(H, W))
    else:
        Phi = (np.where(np.arange(W) < W // 2, 1e6, -1e6)[None, :]
               + np.linspace(0, 40, W)[None, :] + 0.1 * rng.normal(size=(H, W)))
        bad = rng.random((H, W)) < 0.03
        Phi = np.where(bad, Phi + 6 * np.pi, Phi)
    return Phi.astype(np.float32), mask


def _edge_vote_sweep(Phi, mask):
    """One sweep as K4 makes it, in numpy float32: each edge between two
    pixels rounded once (round((Phi_j - Phi_i) / 2pi), IEEE division, half
    to even) and negated for its other end, NaN where an end is outside the
    mask or the image; the pixel moves by a non-zero vote shared by vote 0
    and two others, or by votes 1, 2 and 3 (vote_consensus)."""
    tp = np.float32(2 * np.pi)
    H, W = Phi.shape
    with np.errstate(invalid="ignore"):
        v = np.where(mask[1:] & mask[:-1], np.rint((Phi[1:] - Phi[:-1]) / tp), np.nan)
        h = np.where(mask[:, 1:] & mask[:, :-1], np.rint((Phi[:, 1:] - Phi[:, :-1]) / tp),
                     np.nan)
    k = np.full((4, H, W), np.nan, np.float32)
    k[0, 1:], k[1, :-1] = -v, v                   # above, below
    k[2, :, 1:], k[3, :, :-1] = -h, h             # left, right
    e01, e02, e03 = k[0] == k[1], k[0] == k[2], k[0] == k[3]
    first = (e01 & e02) | (e01 & e03) | (e02 & e03)
    kk = np.where(first, k[0], k[1])
    take = (first | ((k[1] == k[2]) & (k[1] == k[3]))) & (kk != 0)
    return np.where(take, Phi + tp * kk, Phi).astype(np.float32)


@pytest.mark.parametrize("kind", ["holes", "ties", "zeros", "large"])
def test_edge_vote_model_matches_propagation_step(kind):
    """The identity K4 relies on: one rounding per in-mask edge, negated for
    the other end, and the 6-compare consensus give the bits of the port's
    and JAX's ``propagation_step``, sweep after sweep, on tie quotients,
    signed zeros, |Phi| ~ 1e6 and holed masks."""
    Phi, mask = _edge_vote_map(kind)
    if kind == "ties":   # most edges are exact ties before the first sweep
        q = np.abs(Phi[:, 1:] - Phi[:, :-1]) / np.float32(2 * np.pi)
        assert np.mean(q % 1 == 0.5) > 0.9
    q_map = np.ones_like(Phi)
    moved = 0
    for _ in range(3):
        model = _edge_vote_sweep(Phi, mask)
        port, _ = tu.propagation_step(torch.from_numpy(Phi), torch.from_numpy(q_map),
                                      torch.from_numpy(mask))
        ref, _ = ju.propagation_step(jnp.asarray(Phi), jnp.asarray(q_map), jnp.asarray(mask))
        for other in (port.numpy(), np.asarray(ref)):
            np.testing.assert_array_equal(model.view(np.uint32), other.view(np.uint32))
        moved += int((model != Phi).sum())
        Phi = model
    assert moved > 0


def _k3_geometry():
    """K3's tile as csrc/unwrap.cu sets it: (run, warps, halo, blocks an SM)."""
    return tuple(cu_constant("unwrap", f"K3_{n}")
                 for n in ("RUN", "WARPS", "HALO", "BLOCKS_PER_SM"))


def _k3_schedule(Phi, mask, iters, run, warps, h):
    """``iters`` sweeps as K3 schedules them, in numpy: the map cut into tiles
    of (30 warps + 2 - 2h) x (run - 2h) owned cells (the last ones ragged),
    each loaded with a halo of h (outside the image phi 0, mask 0); chunks
    of h sweeps of ``_edge_vote_sweep`` on each tile alone, the last chunk
    iters mod h; between chunks each tile's halo refreshed from the owned
    cells of the tiles around it, the corner cells only with h >= 2 (with
    h = 1 they stay as the tile swept them: no owned cell reads them); then
    every tile's owned cells out."""
    H, W = Phi.shape
    tw, ow, oh = 30 * warps + 2, 30 * warps + 2 - 2 * h, run - 2 * h
    nx, ny = -(-W // ow), -(-H // oh)

    def padded(a):
        out = np.zeros((ny * oh + 2 * h, nx * ow + 2 * h), a.dtype)
        out[h:h + H, h:h + W] = a
        return out

    def cut(a, tx, ty):
        return a[ty * oh:ty * oh + run, tx * ow:tx * ow + tw]

    Pp, Mp = padded(Phi), padded(mask)
    tiles = {(tx, ty): cut(Pp, tx, ty).copy() for tx in range(nx) for ty in range(ny)}
    halo_r = (np.arange(run) < h) | (np.arange(run) >= run - h)
    halo_c = (np.arange(tw) < h) | (np.arange(tw) >= tw - h)
    corner = halo_r[:, None] & halo_c[None, :]
    refresh = (halo_r[:, None] | halo_c[None, :]) & ~(corner & (h == 1))
    done = 0
    while True:
        for key in tiles:
            for _ in range(min(h, iters - done)):
                tiles[key] = _edge_vote_sweep(tiles[key], cut(Mp, *key))
        done += min(h, iters - done)
        owned = np.zeros_like(Pp)
        for (tx, ty), P in tiles.items():
            owned[h + ty * oh:h + (ty + 1) * oh, h + tx * ow:h + (tx + 1) * ow] = \
                P[h:run - h, h:tw - h]
        if done == iters:
            return owned[h:h + H, h:h + W]
        for key in tiles:
            tiles[key] = np.where(refresh, cut(owned, *key), tiles[key])


def _holed_ramp(H, W, seed=5):
    """A noisy ramp with 1 % of its pixels 3 fringe orders off and a mask
    with 12 % holes."""
    rng = np.random.default_rng(seed)
    Phi = np.linspace(0, 40, W)[None, :] + 0.1 * rng.normal(size=(H, W))
    Phi = np.where(rng.random((H, W)) < 0.01, Phi + 6 * np.pi, Phi)
    return Phi.astype(np.float32), rng.random((H, W)) > 0.12


@pytest.mark.parametrize("iters", [1, 3, 4, 9, 17])
@pytest.mark.parametrize("case", ["holes", "ties", "zeros", "large", "3x50", "215x301",
                                  "130x200", "64x1281", "corner_fronts"])
def test_k3_schedule_model_matches_propagation_step(case, iters):
    """K3's schedule (its tiles, h sweeps each with a halo of h, the halo
    refreshed from the tiles around it between chunks, corners only for
    h >= 2, ragged last tiles, iters mod h) gives the bits of the port's and
    JAX's ``propagation_step`` swept ``iters`` times. ``corner_fronts`` repairs
    across every tile corner: at 4 sweeps it differs if the corner cells
    are not exchanged."""
    run, warps, h, _ = _k3_geometry()
    if case == "corner_fronts":
        Phi, mask = corner_fronts(215, 301, run, warps, h)
    elif "x" in case:
        Phi, mask = _holed_ramp(*map(int, case.split("x")))
    else:
        Phi, mask = _edge_vote_map(case)
    q = np.ones_like(Phi)
    port, ref = torch.from_numpy(Phi), jnp.asarray(Phi)
    for _ in range(iters):
        port, _ = tu.propagation_step(port, torch.from_numpy(q), torch.from_numpy(mask))
        ref, _ = ju.propagation_step(ref, jnp.asarray(q), jnp.asarray(mask))
    model = _k3_schedule(Phi, mask, iters, run, warps, h)
    for other in (port.numpy(), np.asarray(ref)):
        np.testing.assert_array_equal(model.view(np.uint32), other.view(np.uint32))
    assert (model != Phi).any()


def _tallest_resident(W):
    """The tallest H <= 16,384 that the route rule sends to K3 at width W."""
    H = min(tus.RESIDENT_BUDGET // (12 * -(-W // 128) * 128) // 8 * 8, 16384)
    assert not tus.takes_tiled(H, W) and (H == 16384 or tus.takes_tiled(H + 1, W))
    return H


H100_SMS = 132


@pytest.mark.parametrize("widths", [range(lo, lo + 1024) for lo in range(1, 16385, 1024)]
                         + [range(121, 129), (1280,)],
                         ids=[f"w{lo}-{lo + 1023}" for lo in range(1, 16385, 1024)]
                         + ["w121-128_h8192", "config3_1280x1024"])
def test_k3_maps_of_the_route_rule_fit_one_wave(widths):
    """Every map the route rule sends to K3 with sides <= 16,384 (at each
    width its tallest) fits one wave of K3's blocks on a 132-SM H100 at the
    blocks an SM of its __launch_bounds__; so do the 121-128 x 8,192 maps and
    the 1280x1024 map that chip_smoke.py times, and a 5 MP map does not."""
    run, warps, h, per_sm = _k3_geometry()
    wave, owned = H100_SMS * per_sm, (30 * warps + 2 - 2 * h, run - 2 * h)
    for W in widths:
        H = 1024 if W == 1280 and len(widths) == 1 else _tallest_resident(W)
        tiles = tus.resident_tiles(H, W, *owned)
        assert tiles <= wave, (H, W, tiles, wave)
    if widths == range(121, 129):
        assert all(_tallest_resident(W) == 8192 for W in widths)
    assert tus.resident_tiles(2048, 2448, *owned) > wave


@pytest.mark.parametrize("shape,resident", [((32, 32768), False), ((16, 65536), False),
                                            ((1024, 1024), True), ((8192, 128), True),
                                            ((1024, 1280), False), ((215, 300), True)])
def test_route_sends_maps_past_one_wave_to_k4(shape, resident):
    """``quality_unwrap``'s route on a 132-SM H100's K3 layout: a map within
    the reference's budget whose tiles exceed one wave (32 x 32768: exactly
    12 MiB padded, 1,130 tiles of 58 x 28 against 1,056) takes K4, as does a
    map past the budget; the maps of K3's route take K3."""
    run, warps, h, per_sm = _k3_geometry()
    layout = (H100_SMS * per_sm, 0, 30 * warps + 2 - 2 * h, run - 2 * h)
    H, W = shape
    assert tus.takes_resident(H, W, layout) == resident
    if shape == (32, 32768):
        assert not tus.takes_tiled(H, W) and tus.resident_tiles(H, W, *layout[2:]) == 1130


@pytest.mark.parametrize("shape", [(64, 96), (215, 300), (1024, 1280), (1024, 1024),
                                   (1032, 1024)])
def test_kernel_dispatch_rule_matches_reference(shape):
    """K4 exactly where the reference leaves its whole-map kernel."""
    H, W = shape
    Hp, Wp = -(-H // 8) * 8, -(-W // 128) * 128
    assert tus.takes_tiled(H, W) == (3 * Hp * Wp * 4 > 12 * 1024 * 1024)
    assert tus.takes_tiled(1024, 1280) and not tus.takes_tiled(215, 300)


def _pass_inputs(seed):
    """A wrapped map with scattered done and eligible pixels and a few
    absolute values for the done ones."""
    rng = np.random.default_rng(seed)
    H, W = 37, 53
    Phi = np.cumsum(rng.normal(0.6, 0.8, size=(H, W)), axis=1).astype(np.float32)
    phi = np.mod(Phi, 2 * np.pi).astype(np.float32)
    done = rng.random((H, W)) < 0.05
    elig = rng.random((H, W)) < 0.8
    Phi_cur = np.where(done, Phi, phi).astype(np.float32)
    return phi, elig, Phi_cur, done


@pytest.mark.parametrize("axis,reverse", [(1, False), (1, True), (0, False), (0, True)])
def test_directional_pass_matches_reference(axis, reverse):
    """The plain Hillis-Steele pass (3-field monoid) against the reference's
    associative scan of the 4-field monoid."""
    phi, elig, Phi, done = _pass_inputs(axis * 2 + reverse)
    (phj, ej, Pj, dj), (pht, et, Pt, dt) = _both(phi, elig, Phi, done)
    oj, rj = ju._directional_pass(Pj, dj, phj, ej, axis, reverse)
    ot, rt = tu.directional_pass(pht, et, Pt, dt, axis, reverse)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert rt.numpy().sum() > done.sum()
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-4)
    # the kernel wrapper takes this plain version on the CPU
    before = _launches("k5")
    ow, rw = twf.wavefront_pass(pht, et, Pt, dt, axis, reverse)
    assert torch.equal(ow, ot) and torch.equal(rw, rt)
    assert _launches("k5") == before


def test_quality_guided_unwrap_matches_reference():
    """Phase-only mode: one seed, four levels, two rounds."""
    _, Phi_n, q, mask = _blob_map()
    phi = np.mod(Phi_n, 2 * np.pi).astype(np.float32)
    (phj, qj, mj), (pht, qt, mt) = _both(phi, q, mask)
    oj, rj = ju.quality_guided_unwrap(phj, qj, mj, levels=4, rounds_per_level=2)
    ot, rt = tu.quality_guided_unwrap(pht, qt, mt, levels=4, rounds_per_level=2)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    assert rt.numpy().mean() > 0.99
    assert np.abs(ot.numpy() - np.asarray(oj))[rt.numpy()].max() < 1e-4
    wo, wr = twf.wavefront_unwrap(pht, qt, mt, levels=4, rounds_per_level=2)
    assert torch.equal(wo, ot) and torch.equal(wr, rt)


@pytest.mark.parametrize("levels,rounds", [(4, 2), (2, 1)])
def test_quality_guided_repair_matches_reference(levels, rounds):
    Phi, Phi_n, q, mask = _blob_map()
    (pj, qj, mj), (pt, qt, mt) = _both(Phi_n, q, mask)
    ref = np.asarray(ju.quality_guided_repair(pj, qj, mj, levels=levels,
                                              rounds_per_level=rounds))
    out = tu.quality_guided_repair(pt, qt, mt, levels=levels, rounds_per_level=rounds)
    assert np.abs(out.numpy() - ref).max() < 1e-4
    # the same repair through the unwrap's repair mode: equal reached maps
    phi, trust = tu.repair_trust(pt, qt, mt)
    _, reached_j = ju.quality_guided_unwrap(jnp.asarray(phi.numpy()), qj, mj, Phi_init=pj,
                                            trust=jnp.asarray(trust.numpy()),
                                            levels=levels, rounds_per_level=rounds)
    _, reached = tu.quality_guided_unwrap(phi, qt, mt, Phi_init=pt, trust=trust,
                                          levels=levels, rounds_per_level=rounds)
    np.testing.assert_array_equal(reached.numpy(), np.asarray(reached_j))
    # the blob and every isolated error repaired
    assert np.abs(out.numpy() - Phi).max() < 1e-3


def test_wavefront_repair_matches_pallas_kernel():
    """The reference's K5 repair (interpret mode) with its light repair
    defaults (2 levels, 1 round: 8 passes) against the port's."""
    Phi, Phi_n, q, mask = _blob_map()
    (pj, qj, mj), (pt, qt, mt) = _both(Phi_n, q, mask)
    ref = np.asarray(wavefront_repair_pallas(pj, qj, mj))
    out = twf.wavefront_repair(pt, qt, mt)
    assert np.abs(out.numpy() - ref).max() < 1e-4
    assert np.abs(out.numpy() - Phi).max() < 1e-3
    assert torch.equal(out, tu.quality_guided_repair(pt, qt, mt, levels=2,
                                                     rounds_per_level=1))


def test_thresholds_and_seed_match_reference():
    """Quantile thresholds (linear, NaN outside the mask) and the seed
    (the first highest-quality masked pixel) as jnp computes them."""
    rng = np.random.default_rng(4)
    q = rng.choice(np.float32([0.2, 0.5, 0.9, 0.9]), size=(11, 13)).astype(np.float32)
    q[3, 4:] = 0.95
    mask = rng.random((11, 13)) > 0.2
    mask[3, 4] = False   # the first maximum is masked: the seed is the next
    mask[3, 5] = True
    for levels in (2, 3, 4):
        ref = np.asarray(jnp.nanquantile(jnp.where(mask, q, jnp.nan),
                                         jnp.linspace(1.0 - 1.0 / levels, 0.0, levels)))
        out = torch.nanquantile(torch.where(torch.from_numpy(mask), torch.from_numpy(q),
                                            torch.nan),
                                torch.linspace(1.0 - 1.0 / levels, 0.0, levels))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    phi = np.zeros((11, 13), np.float32)
    _, reached = tu.quality_guided_unwrap(torch.from_numpy(phi), torch.from_numpy(q),
                                          torch.from_numpy(mask), levels=1,
                                          rounds_per_level=0)
    assert reached.nonzero().tolist() == [[3, 5]]


def test_spatial_repair_never_leaves_the_mask():
    """The port's ``changed`` rule: only masked pixels moved by more than
    half a period; the x_p -> phase -> x_p round trip moves none."""
    Phi, Phi_n, q, mask, bad = _voting_map(True)
    pitch = 8.0
    x_p = torch.from_numpy(Phi_n * np.float32(pitch / (2 * np.pi)) + 400.0)
    for mode in ("voting", "wavefront"):
        x_p2, changed = spatial_repair(x_p, torch.from_numpy(q), torch.from_numpy(mask),
                                       pitch, 4, mode)
        assert not changed[~torch.from_numpy(mask)].any()
        assert changed.any() and changed.numpy()[mask].sum() <= bad[mask].sum()
        # the round trip alone moves x_p by float rounding only
        assert float((x_p2 - x_p)[~changed].abs().max()) < 1e-3
    with pytest.raises(ValueError, match="spatial_mode"):
        spatial_repair(x_p, torch.from_numpy(q), torch.from_numpy(mask), pitch, 4, "flood")
