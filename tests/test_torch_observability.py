"""The recorder of ``slr_torch.observability``: spans, waits and counters.

Its bookkeeping (nesting, parents, requests, self time, the ring's bound,
the counters and the switch), its clock against the profiler's, that no
span reaches the profiler, the Chrome trace, and the exact span trees of
the scan path and of a small fused-model job on the CPU. On the CPU no call
waits for a card, but the ``wait`` spans mark the same calls.
"""

import json
import os
import warnings

import pytest
import torch

from slr_torch import observability as obs
from slr_torch.config import DecodeConfig, PatternConfig, RegistrationConfig
from slr_torch.dist.batch import batched_reconstruct
from slr_torch.geom.se3 import so3_exp
from slr_torch.kernels import fused_scan as fs
from slr_torch.pipeline import reconstruct_stream
from slr_torch.pipeline import registerfuse as rf
from slr_torch.pipeline import tsdf
from slr_torch.pipeline.reconstruct import ScanCloud, reconstruct_dense
from slr_torch.synth.render import default_rig, move_rig, render_scan
from slr_torch.synth.scene import bumps_depth, rocks_scene

torch.set_num_threads(2)

W, H = 160, 128
CFG = PatternConfig(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4)


def _new_spans(mark: int) -> list:
    return [s for s in obs.snapshot().spans if s.id > mark]


def _mark() -> int:
    spans = obs.snapshot().spans
    return max((s.id for s in spans), default=0)


def _tree(spans) -> list:
    """The spans as nested (name, children) in the order they opened; a
    wait's name ends in "!"."""
    kids, ids = {}, {s.id for s in spans}
    for s in sorted(spans, key=lambda s: s.id):
        kids.setdefault(s.parent, []).append(s)

    def node(s):
        return (s.name + ("!" if s.wait else ""), [node(c) for c in kids.get(s.id, [])])

    return [node(s) for s in sorted(spans, key=lambda s: s.id) if s.parent not in ids]


def _leaves(*names):
    return [(n, []) for n in names]


# ------------------------------------------------------------- bookkeeping

def test_nesting_parents_requests_and_self_time():
    mark = _mark()
    with obs.span("t.root") as root:
        with obs.span("t.child") as child:
            with obs.wait("t.sync") as sync:
                pass
        with obs.span("t.child"):
            pass
    with obs.span("t.other") as other:
        pass
    got = {s.id: s for s in obs.snapshot().spans}
    r, c, w, o = (got[x.id] for x in (root, child, sync, other))
    assert (r.parent, c.parent, w.parent, o.parent) == (0, r.id, c.id, 0)
    assert r.request == c.request == w.request == r.id and o.request == o.id
    assert w.wait and not (r.wait or c.wait or o.wait)
    assert r.start_ns <= c.start_ns <= w.start_ns <= w.end_ns <= c.end_ns <= r.end_ns
    # self time, from the ring: the root's duration less its two children's,
    # which lie one after the other inside it
    children = sorted((s for s in got.values() if s.parent == r.id), key=lambda s: s.id)
    assert [s.name for s in children] == ["t.child", "t.child"]
    assert children[0].end_ns <= children[1].start_ns <= children[1].end_ns <= r.end_ns
    own = (r.end_ns - r.start_ns) - sum(s.end_ns - s.start_ns for s in children)
    assert 0 <= own <= r.end_ns - r.start_ns
    assert [s.name for s in _new_spans(mark)] == ["t.sync", "t.child", "t.child", "t.root",
                                                  "t.other"]


def test_a_request_is_handed_to_root_spans():
    with obs.span("t.enqueue") as enq:
        pass
    with obs.request(enq.request):
        with obs.span("t.scan") as scan:
            with obs.span("t.inner") as inner:
                pass
    with obs.span("t.next") as nxt:
        pass
    got = {s.id: s for s in obs.snapshot().spans}
    assert got[scan.id].request == got[inner.id].request == got[enq.id].id
    assert got[scan.id].parent == 0 and got[nxt.id].request == nxt.id


def test_the_ring_holds_the_newest_spans():
    before = obs.snapshot()
    mark = max((s.id for s in before.spans), default=0)
    extra = 10
    for i in range(obs.RING + extra):
        with obs.span("t.ring"):
            pass
    snap = obs.snapshot()
    assert obs.RING >= 1 << 17 and len(snap.spans) == obs.RING
    # every span closed is held or counted as dropped
    assert (len(snap.spans) + snap.dropped
            == len(before.spans) + before.dropped + obs.RING + extra)
    assert snap.dropped >= extra
    # the oldest of this run were dropped, the newest kept, in order
    ids = [s.id for s in snap.spans]
    assert ids == sorted(ids) and ids[0] > mark + extra
    assert {s.name for s in snap.spans} == {"t.ring"}


def test_an_upload_waits_only_where_it_copies():
    mark = _mark()
    host = obs.upload("t.up", [1.0, 2.0], "cpu")
    held = torch.empty(3, device="meta")        # a tensor off the host
    same = obs.upload("t.up", held)
    assert torch.equal(host, torch.tensor([1.0, 2.0])) and same is held
    assert [(s.name, s.syncs) for s in _new_spans(mark)] == [("t.up", 1), ("t.up", 0)]


def test_counters_and_the_switch():
    base = obs.snapshot().counts.get("t.count", 0)
    obs.count("t.count")
    obs.count("t.count", 4)
    assert obs.snapshot().counts["t.count"] == base + 5
    mark = _mark()
    was = obs.recording(False)
    try:
        assert was is True
        obs.count("t.count", 100)
        with obs.span("t.off") as sp:
            with obs.wait("t.off.sync"):
                pass
        assert sp.request == 0
    finally:
        assert obs.recording(was) is False
    assert obs.snapshot().counts["t.count"] == base + 5
    assert _new_spans(mark) == []
    with obs.span("t.on"):
        pass
    assert [s.name for s in _new_spans(mark)] == ["t.on"]


# ------------------------------------------------------- the profiler's clock

def test_spans_share_the_profilers_clock():
    """A span opened around a ``record_function`` brackets the profiler's
    event: ``time.time_ns()`` is the clock of its timestamps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    gaps = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(6):
            with obs.span("t.clock") as sp:
                with record_function(f"t_clock_{i}"):
                    torch.ones(8).sum()
            gaps.append((i, sp.id))
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("t_clock_")}
    got = {s.id: s for s in obs.snapshot().spans}
    lead, tail = [], []
    for i, sid in gaps[1:]:             # the first call warms the profiler up
        ev, s = events[f"t_clock_{i}"], got[sid]
        lead.append(ev.start_ns() - s.start_ns)
        tail.append(s.end_ns - ev.end_ns())
    assert min(lead) >= 0 and min(tail) >= 0
    assert min(lead) < 50_000 and min(tail) < 50_000


def _repair_scan():
    cam, proj = default_rig(cam_w=W, cam_h=H, proj_w=256, proj_h=192)
    scan = render_scan(cam, proj, bumps_depth(H, W, base=480.0, amp=30.0), CFG,
                       noise_std=0.005, generator=torch.Generator().manual_seed(3))
    return cam, proj, scan.frames


def test_no_program_span_reaches_the_profiler():
    from torch.profiler import ProfilerActivity, profile

    cam, proj, frames = _repair_scan()
    mark = _mark()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        reconstruct_dense(frames, cam, proj, CFG, spatial_iters=4)
    names = {s.name for s in _new_spans(mark)}
    assert {"scan", "repair", "repair.vote"} <= names
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert events and not names & events


def test_trace_writes_the_programs_spans(tmp_path):
    """The operator's view: the Chrome trace holds the recorder's spans of
    the traced body on the profiler's clock, beside its own events."""
    from torch.profiler import record_function

    with obs.span("t.before"):
        pass
    with obs.trace(str(tmp_path / "tr")):
        with obs.span("t.traced") as sp:
            with record_function("t_traced_rf"):
                torch.ones(8).sum()
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    events = data["traceEvents"]
    ours = [e for e in events if e.get("cat") == "slr_span"]
    assert [e["name"] for e in ours] == ["t.traced"]
    rf_ev = [e for e in events if e.get("name") == "t_traced_rf"][0]
    mine = ours[0]
    assert mine["ph"] == "X" and mine["args"]["id"] == sp.id and mine["args"]["syncs"] == 0
    assert mine["ts"] <= rf_ev["ts"] and rf_ev["ts"] + rf_ev["dur"] <= mine["ts"] + mine["dur"]


# -------------------------------------------------------------- span trees

@pytest.mark.parametrize("spatial_iters", [0, 4])
def test_scan_span_tree(spatial_iters):
    """``reconstruct_dense`` is one ``scan`` root; the repair adds its
    phase conversions, its vote and its re-triangulation. The CPU takes
    K1's plain version, so no parameter block is read: no wait."""
    cam, proj, frames = _repair_scan()
    mark = _mark()
    reconstruct_dense(frames, cam, proj, CFG, spatial_iters=spatial_iters)
    spans = _new_spans(mark)
    repair = [("repair", _leaves("repair.phase", "repair.vote", "repair.phase",
                                 "repair.retriangulate"))]
    assert _tree(spans) == [("scan", repair if spatial_iters else [])]
    assert sum(s.wait for s in spans) == 0
    assert len({s.request for s in spans}) == 1


def test_the_parameter_block_is_one_wait():
    """On the card ``fused_decode_triangulate`` builds K1's parameter block
    under ``k1.params`` and reads the calibration to the host once."""
    cam, proj, _ = _repair_scan()
    mark = _mark()
    fs.scan_params(cam, proj, CFG, DecodeConfig(), (1.0, 1e4), 8, H, W)
    assert _tree(_new_spans(mark)) == [("params.read!", [])]


def test_the_stream_hands_each_enqueue_to_its_scan():
    cam, proj, frames = _repair_scan()
    mark = _mark()
    out = list(reconstruct_stream(iter([frames] * 3), cam, proj, CFG, prefetch=2,
                                  device="cpu"))
    assert len(out) == 3
    spans = _new_spans(mark)
    assert _tree(spans) == _leaves("stream.enqueue", "stream.enqueue", "scan",
                                   "stream.enqueue", "scan", "scan")
    enq = sorted((s for s in spans if s.name == "stream.enqueue"), key=lambda s: s.id)
    scans = sorted((s for s in spans if s.name == "scan"), key=lambda s: s.id)
    assert [s.request for s in scans] == [e.id for e in enq]
    assert all(e.end_ns <= s.start_ns for e, s in zip(enq, scans))


def _orbit(n=3):
    cam, proj = default_rig(cam_w=W, cam_h=H, proj_w=256, proj_h=192)
    gen = torch.Generator().manual_seed(5)
    stacks = []
    for s in range(n):
        R = so3_exp(torch.tensor([0.0, 0.025, 0.008]) * s)
        c, p = move_rig(cam, proj, R, torch.tensor([7.0, -3.0, 0.0]) * s)
        stacks.append(render_scan(c, p, rocks_scene(c, H, W), CFG, noise_std=0.003,
                                  generator=gen).frames)
    return cam, proj, torch.stack(stacks)


def test_fused_model_span_tree(tmp_path):
    """A small fused-model job (3 scans) on the CPU: one root a stage, the
    registration's three rounds (the chain with its race, the closures, the
    closures' race), every wait where the card would make the host wait."""
    cam, proj, stacks = _orbit()
    mark = _mark()
    batch = batched_reconstruct(stacks, cam, proj, CFG)
    clouds = [ScanCloud(*(x[i] for x in batch)) for i in range(len(stacks))]
    reg = rf.register_scans_batched(clouds, RegistrationConfig(icp_sample_points=256),
                                    cam=cam)
    reg = rf.ba_refine(clouds, reg, n_landmarks=64, iters=2)
    rf.fuse_scans(clouds, reg, RegistrationConfig(voxel_size=2.0), capacity=1 << 14)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        vol = tsdf.fuse_tsdf(clouds, cam, reg.R, reg.t, size_vox=(32,) * 3, voxel=4.0)
    n_verts, _ = tsdf.write_tsdf_mesh_obj(os.path.join(tmp_path, "m.obj"), vol)
    assert n_verts > 0
    spans = _new_spans(mark)
    up = _leaves("register.upload!", "register.upload!")
    fit = _leaves("ransac.edges!", "ransac.edges!", "kabsch.svd!", "kabsch.svd!", "kabsch.svd!")
    race = [*_leaves("features.fpfh", "features.match", "features.draws"), ("features.fit", fit)]
    icp = _leaves("icp", "icp.polish")
    axis = _leaves(*["normals.axis!"] * 3)      # a grid's normals: one scalar written
    assert _tree(spans) == [
        ("decode", _leaves("scan", "scan", "scan")),
        ("register", [("register.samples", axis + axis),
                      ("register.round", up + icp + race + icp),
                      ("register.round", up + icp),
                      ("register.round", up + race + icp),
                      ("register.accept!", []),
                      ("pose_graph", up)]),
        ("ba", axis + _leaves("ba.associate", "ba.solve", "ba.associate", "ba.solve")),
        ("fuse", []),
        ("tsdf", _leaves("tsdf.bounds!", "tsdf.upload!", "tsdf.upload!", "tsdf.upload!",
                         "tsdf.integrate", "tsdf.integrate", "tsdf.integrate")),
        ("mesh_write", [("mesh.extract", _leaves("mesh.count!", "mesh.table!", "mesh.table!",
                                                 "mesh.table!", "mesh.table!", "mesh.mask!")),
                        *_leaves("mesh.text", "mesh.read!", "mesh.text", "mesh.read!",
                                 "mesh.file")]),
    ]
    # each wait one call; an edge list's indices (two copies) and an SVD
    # (two checks) sync twice
    assert sum(s.wait for s in spans) == 40 and sum(s.syncs for s in spans) == 50
    # the orbit's poses handed over, as a turntable gives them: four uploads
    mark = _mark()
    rf.registered_scans_from_numpy(reg.R.numpy(), reg.t.numpy(), reg.icp_rms.numpy(),
                                   reg.pg_rms.numpy())
    assert _tree(_new_spans(mark)) == _leaves(*["poses.upload!"] * 4)
