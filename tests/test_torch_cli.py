"""slr_torch.cli (CPU, ``--device cpu``): the commands drive the port's
Session end to end on a small ScanConfig (256x160 camera), the two-camera
demo runs, ``--noise 0`` renders reconstruct to the JAX CLI's clouds on the
same session within rtol 1e-5 / atol 1e-5 (where x_p agrees within
1e-3 px, as tests/test_torch_session.py; the port's own render flips codes
on at most 2e-3 of the pixels, its stripe edges), and the options of later
slices refuse with their messages.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import slr.cli as jcli
import slr.config as jcfg
import slr_torch.config as tcfg
from slr_torch.cli import main
from slr_torch.io import load_stage, read_ply
from slr_torch.pipeline import Session

torch.set_num_threads(2)

PATTERN = dict(proj_width=256, proj_height=192, gray_bits=6, phase_steps=4)
REG = dict(icp_sample_points=1024, ransac_iters=64, icp_iters=10, pg_iters=10)


def _small(mod, root):
    cfg = mod.ScanConfig(pattern=mod.PatternConfig(**PATTERN),
                         registration=mod.RegistrationConfig(**REG),
                         cam_width=256, cam_height=160)
    mod.save_config(cfg, f"{root}/config.json")
    return cfg


def test_cli_product_path(tmp_path, capsys):
    root = str(tmp_path / "sess")
    (tmp_path / "sess").mkdir()
    _small(tcfg, root)
    cpu = ["--device", "cpu"]
    for pose in range(3):
        main(cpu + ["scan", "--session", root, "--scene", "bumps", "--pose", str(pose)])
    main(cpu + ["reconstruct", "--session", root, "--index", "0", "--accumulate", "--ply"])
    for i in (1, 2):
        main(cpu + ["reconstruct", "--session", root, "--index", str(i)])
    d = load_stage(tmp_path / "sess" / "clouds" / "scan_000.npz")
    n_cells, n_px = int(d["acc_mask"].sum()), int(d["mask"].sum())
    assert 0 < n_cells <= n_px
    assert np.isfinite(d["acc_points"][d["acc_mask"]]).all()
    pts, _, _ = read_ply(tmp_path / "sess" / "clouds" / "scan_000.ply")
    assert pts.shape == (n_px, 3)
    main(cpu + ["register", "--session", root])
    reg = load_stage(tmp_path / "sess" / "registration.npz")
    assert reg["R"].shape == (3, 3, 3) and np.isfinite(reg["t"]).all()
    main(cpu + ["fuse", "--session", root, "--mesh", "--voxel", "6.0"])
    assert read_ply(tmp_path / "sess" / "fused.ply")[0].shape[0] > 1000
    assert (tmp_path / "sess" / "fused_mesh.obj").read_text().count("\nf ") > 100
    main(cpu + ["view", "--session", root, "--frames", "2", "--size", "64"])
    main(cpu + ["view", "--session", root, "--cloud", "1", "--size", "64",
                "--out", str(tmp_path / "one")])
    out = capsys.readouterr().out
    assert "wrote 2 view(s)" in out and "registered 3 scans" in out
    assert list(tmp_path.glob("sess/preview_0*")) and list(tmp_path.glob("one_00.*"))

    # calibration out to OpenCV YAML and back, scans out to PGM and back
    yml = str(tmp_path / "calib.yml")
    main(cpu + ["export-calib", "--session", root, "--out", yml])
    root2 = str(tmp_path / "sess2")
    main(cpu + ["import-calib", "--session", root2, "--yaml", yml])
    s1, s2 = Session(root, device="cpu"), Session(root2, device="cpu")
    for a, b in zip((*s1.cam, *s1.proj), (*s2.cam, *s2.proj)):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-4)
    assert s2.calib_meta["source"] == "opencv_yaml"
    main(cpu + ["export-scan", "--session", root, "--index", "1", "--folder",
                str(tmp_path / "frames")])
    main(cpu + ["import-scan", "--session", root2, "--folder", str(tmp_path / "frames")])
    np.testing.assert_allclose(s2.load_scan(0).numpy(), s1.load_scan(1).numpy(),
                               atol=1.0 / 65535)


def test_cli_calibrate_synthetic_corners(tmp_path, capsys):
    root = str(tmp_path / "cal")
    (tmp_path / "cal").mkdir()
    _small(tcfg, root)
    main(["--device", "cpu", "calibrate", "--session", root, "--synthetic-corners"])
    assert "joint rms" in capsys.readouterr().out
    sess = Session(root, device="cpu")
    assert sess.calib_meta["rms"] < 0.05
    assert abs(float(sess.cam.fx) - 0.9 * 256) < 0.5


def test_cli_stereo_demo(tmp_path, capsys):
    root = str(tmp_path / "stereo")
    main(["--device", "cpu", "stereo-demo", "--out", root, "--cam-w", "320", "--cam-h", "256"])
    out = capsys.readouterr().out
    rms = float(out.split("RMS ")[1].split()[0])
    assert rms < 0.1, out
    assert read_ply(tmp_path / "stereo" / "stereo.ply")[0].shape[0] > 10000
    sess = Session(root, device="cpu")
    assert sess.cam2 is not None and sess.load_scan(0, second=True) is not None


def test_cli_noiseless_scans_match_the_jax_cli(tmp_path):
    """``--noise 0``: the JAX CLI scans and reconstructs a session; the
    port's CLI reconstructs the same session, and scans and reconstructs one
    of its own; all three clouds agree."""
    jroot, troot = str(tmp_path / "j"), str(tmp_path / "t")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    _small(jcfg, jroot)
    _small(tcfg, troot)
    for root, cli, extra in ((jroot, jcli.main, []), (troot, main, ["--device", "cpu"])):
        cli(extra + ["scan", "--session", root, "--pose", "1", "--noise", "0"])
        cli(extra + ["reconstruct", "--session", root, "--index", "0"])
    cj = load_stage(f"{jroot}/clouds/scan_000.npz")
    ct = load_stage(f"{troot}/clouds/scan_000.npz")
    main(["--device", "cpu", "reconstruct", "--session", jroot, "--index", "0"])
    cx = load_stage(f"{jroot}/clouds/scan_000.npz")
    # the port's own render differs from JAX's on stripe-edge pixels (at
    # most 2e-3 of them, tests/test_torch_registerfuse.py), where a code can
    # flip; the port reconstructing JAX's scans holds the decode's 1e-4
    for c, flips in ((ct, 2e-3), (cx, 1e-4)):
        assert (c["mask"] != cj["mask"]).mean() <= 1e-3
        both = c["mask"] & cj["mask"]
        assert both.mean() > 0.3
        dx = np.abs(c["x_p"] - cj["x_p"])
        assert (dx[both] > 1e-3).mean() <= flips
        agree = both & (dx <= 1e-3)
        np.testing.assert_allclose(c["points"][agree], cj["points"][agree],
                                   rtol=1e-5, atol=1e-5)


def test_cli_demo_with_a_pixel_tile_layout(tmp_path, capsys):
    """``demo`` end to end on the CPU (the calibration image route needs a
    board the detector can order: a 640x512 camera), with a 2-tile layout
    that one device runs as the reference's fallback (``mesh_fallback``)."""
    out = tmp_path / "demo"
    out.mkdir()
    tcfg.save_config(tcfg.ScanConfig(registration=tcfg.RegistrationConfig(**REG),
                                     cam_width=640, cam_height=512), out / "config.json")
    main(["--device", "cpu", "demo", "--out", str(out), "--scans", "2", "--pixel-tiles", "2"])
    captured = capsys.readouterr()
    assert '"event": "mesh_fallback"' in captured.err
    sess = Session(out, device="cpu")
    assert sess.config.dist.pixel_tiles == 2 and sess.cloud_count() == 2
    assert sess.calib_meta["rms"] < 0.5
    assert read_ply(out / "fused.ply")[0].shape[0] > 1000


def test_cli_refuses_later_slices(tmp_path):
    with pytest.raises(SystemExit, match="benchmark"):
        main(["bench"])
    with pytest.raises(NotImplementedError, match="slice 8"):
        main(["--device", "cpu", "--num-procs", "2", "--proc-id", "0", "demo",
              "--out", str(tmp_path / "d")])
    with pytest.raises(NotImplementedError, match="slice 8"):
        main(["--device", "cpu", "--coordinator", "localhost:1234", "bench"])
    # the shell sees a non-zero exit and the message, not the JAX bench
    proc = subprocess.run([sys.executable, "-m", "slr_torch.cli", "bench"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "benchmark" in proc.stderr and not proc.stdout


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["scan", "--session", str(tmp_path / "s")])
