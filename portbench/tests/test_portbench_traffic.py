"""The traffic generators driven end to end on CPU tensors through the
program's plain paths at a small size, the control against the limits, and
runs with the timed path broken underneath, each of which has to come out
not correct."""

import time

import pytest
import torch

from portbench import harness

SMALL_CAM = {"camera": {"width": 160, "height": 128}}
SMALL_MIX = {"pool": 3, "orbits": 1, "profile_scans": 4, "profile_models": 1}
# the repair moves ~30 pixels of a full-size config-3 stack and none at the
# small size: the repair's own checks run at the configuration's size
FULL_MIX = {"pool": 2, "profile_scans": 2}


def _run(cell, cfg=SMALL_CAM, mix=SMALL_MIX, seconds=0.5, seed=2**31 + 77):
    torch.manual_seed(0)
    return harness.run_cell(cell, seed, seconds, False, time.perf_counter(), device="cpu",
                            cfg_override=cfg, mix_override=mix)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", ["scan_stream", "scan_stream_repair"])
def test_scan_cells_run_and_agree(cell):
    out = _run(cell)
    assert out["attempted"] > 0 and out["failed"] == 0
    bench = harness.manifest()
    assert set(out["metrics"]) == {m["name"] for m in bench["end_to_end"]
                                   if harness.reports(m, cell, bench)}
    assert {"scan_p95_ms", "setup_s"} <= set(out["metrics"])
    assert out["checks"]["off_pixel_share"]["value"] == 0.0
    assert out["correct"] is True
    assert list(out)[-1] == "checks"


def test_fusion_known_poses_runs_and_agrees():
    out = _run("fusion_known_poses8", seconds=0.1)
    assert out["attempted"] == 1 and set(out["metrics"]) == {"model_ms", "setup_s"}
    checks = out["checks"]
    assert set(checks) == {"off_pixel_share", "fused_off_share", "mesh_off_share",
                           "mesh_face_gap"}
    assert checks["off_pixel_share"]["value"] == 0.0
    assert checks["mesh_face_gap"]["value"] < checks["mesh_face_gap"]["limit"]
    assert out["correct"] is True


def _control(cell, cfg, mix):
    _, conf, m, gen = harness.load_cell(cell)
    conf.update(cfg)
    traffic = gen.Traffic(conf, {**m["params"], **mix}, 2**31 + 5, "cpu")
    traffic.setup()
    traffic.window(0.1, sync_spans=False)     # the model the control stands in for
    try:
        return traffic.control_readings(), conf["checks"]["limits"]
    finally:
        traffic.close()


@pytest.mark.parametrize("cell,cfg,mix", [
    ("scan_stream", SMALL_CAM, SMALL_MIX),
    ("fusion_known_poses8", SMALL_CAM, SMALL_MIX),
    ("scan_stream_repair", {}, FULL_MIX)])
def test_control_fails_a_limit(cell, cfg, mix):
    """The reference in TF32 in the program's place is not correct."""
    got, limits = _control(cell, cfg, mix)
    assert any(v > limits[k] for k, v in got.items()), got


def _altered(fn, field):
    def run(*a, **k):
        out = fn(*a, **k)
        x = getattr(out, field).clone()
        x[40:48, 60:70] += 0.05 if field == "points" else 1.0
        return out._replace(**{field: x})
    return run


@pytest.mark.parametrize("field", ["points", "x_p"])
def test_scan_answer_altered_is_not_correct(monkeypatch, field):
    import slr_torch.pipeline.stream as stream

    monkeypatch.setattr(stream, "reconstruct_dense", _altered(stream.reconstruct_dense, field))
    out = _run("scan_stream")
    assert out["correct"] is False
    assert out["checks"]["off_pixel_share"]["value"] > out["checks"]["off_pixel_share"]["limit"]


def test_repair_left_unchanged_is_not_correct(monkeypatch):
    import slr_torch.pipeline.reconstruct as rc

    monkeypatch.setattr(rc, "spatial_repair",
                        lambda x_p, quality, mask, *a, **k: (x_p, torch.zeros_like(mask)))
    out = _run("scan_stream_repair", cfg={}, mix=FULL_MIX, seconds=0.1)
    assert out["correct"] is False
    assert out["checks"]["repair_miss_share"]["value"] == 1.0


def test_registration_left_unchanged_is_not_correct(monkeypatch):
    """The poses left at their start (the identity), BA then run on them."""
    import slr_torch.pipeline.registerfuse as rf

    def unchanged(clouds, *a, **k):
        S, dev = len(clouds), clouds[0].points.device
        return rf.RegisteredScans(R=torch.eye(3, device=dev).expand(S, 3, 3).clone(),
                                  t=torch.zeros(S, 3, device=dev),
                                  icp_rms=torch.zeros(S - 1, device=dev),
                                  pg_rms=torch.zeros((), device=dev))

    monkeypatch.setattr(rf, "register_scans_batched", unchanged)
    monkeypatch.setattr(rf, "ba_refine", lambda clouds, reg, *a, **k: reg)
    out = _run("fusion_orbit8", seconds=0.1)
    assert out["correct"] is False
    assert out["checks"]["pose_rot_deg"]["value"] > 0.5


def test_fusion_decode_altered_is_not_correct(monkeypatch):
    import slr_torch.dist.batch as batch

    monkeypatch.setattr(batch, "reconstruct_dense", _altered(batch.reconstruct_dense, "points"))
    out = _run("fusion_known_poses8", seconds=0.1)
    assert out["correct"] is False
    assert out["checks"]["off_pixel_share"]["value"] > out["checks"]["off_pixel_share"]["limit"]


def _first_half(fn, *poses):
    """``fn`` over the first half of the scans (and of the poses given)."""
    def run(clouds, *a, **k):
        h = len(clouds) // 2
        a = list(a)
        for i in poses:
            a[i] = a[i][:h] if not hasattr(a[i], "_replace") else a[i]._replace(
                R=a[i].R[:h], t=a[i].t[:h])
        return fn(clouds[:h], *a, **k)
    return run


def test_fusion_half_scans_fused_is_not_correct(monkeypatch):
    """The voxel fuse and the TSDF take half of the batch of scans."""
    import slr_torch.pipeline.registerfuse as rf
    import slr_torch.pipeline.tsdf as tsdf

    monkeypatch.setattr(rf, "fuse_scans", _first_half(rf.fuse_scans, 0))
    monkeypatch.setattr(tsdf, "fuse_tsdf", _first_half(tsdf.fuse_tsdf, 1, 2))
    out = _run("fusion_known_poses8", seconds=0.1)
    assert out["correct"] is False
    for name in ("fused_off_share", "mesh_off_share"):
        assert out["checks"][name]["value"] > out["checks"][name]["limit"], name


def test_fusion_half_faces_written_is_not_correct(monkeypatch):
    """The OBJ writer leaves every second face out."""
    import slr_torch.pipeline.tsdf as tsdf

    extract = tsdf.extract_mesh

    def halved(vol, with_colors=False):
        out = extract(vol, with_colors=with_colors)
        keep = torch.arange(out[1].shape[0]) % 2 == 0
        return (out[0], out[1][keep], *out[2:])

    monkeypatch.setattr(tsdf, "extract_mesh", halved)
    out = _run("fusion_known_poses8", seconds=0.1)
    assert out["correct"] is False
    assert out["checks"]["mesh_face_gap"]["value"] > out["checks"]["mesh_face_gap"]["limit"]
