"""slr_torch command-line interface (port of ``slr/cli.py``): calibrate,
scan (synthetic capture), reconstruct, register, fuse, view, the scan and
calibration import/export, and the demos, each on ``slr_torch.Session``.

Usage:
    python -m slr_torch.cli demo --out slr_demo          # full synthetic run
    python -m slr_torch.cli scan --session S --scene bumps --pose 0
    python -m slr_torch.cli calibrate --session S
    python -m slr_torch.cli reconstruct --session S --index 0
    python -m slr_torch.cli register --session S
    python -m slr_torch.cli fuse --session S
    python -m slr_torch.cli --device cpu demo --out slr_demo   # on the CPU

Every command runs on the card (``--device cuda``, the default) and raises
without one unless given ``--device cpu``. Noise comes from seeded
``torch.Generator``s, so a noisy render is not JAX's bit for bit; with
``--noise 0`` the two CLIs render the same scans. ``bench`` comes with the
port's first benchmark.

A job of several processes: start one process a GPU, each with
``--coordinator HOST:PORT --num-procs N --proc-id R`` (NCCL; rank R on
``cuda:R``), or with ``--device cpu`` for Gloo ranks on the CPU, and the
same command. ``demo --pixel-tiles/--map-blocks`` then takes the sharded
routes when the job has that many ranks; only rank 0 writes the session.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import numpy as np
import torch

from slr_torch.pipeline import Session


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def cmd_scan(args):
    """Synthetic capture: render a pattern stack of a scene from a pose
    into the session (the stand-in for projector + camera IO)."""
    from slr_torch.geom.se3 import so3_exp
    from slr_torch.synth import default_rig, move_rig, render_scan, sphere_depth, spheres_scene

    sess = Session(args.session, device=args.device)
    dev = sess.device
    p = sess.config.pattern
    cam, proj = default_rig(
        cam_w=sess.config.cam_width, cam_h=sess.config.cam_height,
        proj_w=p.proj_width, proj_h=p.proj_height, device=dev,
    )
    if sess.cam is None:
        sess.set_calibration(cam, proj, {"source": "default_rig"})
    H, W = sess.config.cam_height, sess.config.cam_width
    # rig moved per scan index (true rigid multi-scan ground truth)
    rv = torch.tensor([0.0, 0.03 * args.pose, 0.01 * args.pose], device=dev)
    tv = torch.tensor([8.0 * args.pose, -4.0 * args.pose, 0.0], device=dev)
    cam_s, proj_s = move_rig(cam, proj, so3_exp(rv), tv)
    if args.scene == "sphere":
        depth = sphere_depth(cam_s, H, W, center=[0, 0, 520.0], radius=120.0,
                             background=700.0)
    else:  # asymmetric plane + spheres scene (registration-friendly)
        depth = spheres_scene(cam_s, H, W)
    scan = render_scan(cam_s, proj_s, depth, p, noise_std=args.noise,
                       generator=_generator(dev, args.pose))
    idx = sess.add_scan(scan.frames)
    print(f"scan {idx} captured (rig pose {args.pose}) -> {args.session}/scans/")


def cmd_calibrate(args):
    from slr_torch.synth import default_rig

    sess = Session(args.session, device=args.device)
    dev = sess.device
    c = sess.config.calib
    cam_true, proj_true = default_rig(
        cam_w=sess.config.cam_width, cam_h=sess.config.cam_height,
        proj_w=sess.config.pattern.proj_width,
        proj_h=sess.config.pattern.proj_height, device=dev,
    )

    if getattr(args, "synthetic_corners", False):
        # corner coordinates injected analytically: exercises the solvers
        # only, not detection or decode
        from slr_torch.calib import (
            calibrate_camera, calibrate_projector, stereo_calibrate, synth_board_views)
        from slr_torch.geom.camera import project
        from slr_torch.geom.se3 import so3_exp

        obj, img_c, rvs, tvs = synth_board_views(
            cam_true, c.board_cols, c.board_rows, c.square_size,
            n_views=8, seed=0, noise_px=args.noise_px, generator=_generator(dev, 0),
        )
        img_p = torch.stack([project(proj_true, obj @ so3_exp(rvs[v]).T + tvs[v])[0]
                             for v in range(img_c.shape[0])])
        cam_res = calibrate_camera(obj, img_c, lm_iters=c.lm_iters)
        proj_res = calibrate_projector(obj, img_p, lm_iters=c.lm_iters)
        st = stereo_calibrate(obj, img_c, img_p, cam_res, proj_res)
    else:
        # the full physical procedure: render the board under white light
        # and the pattern stack, detect corners, decode, solve
        from slr_torch.calib import calibrate_from_images
        from slr_torch.synth import board_poses, render_board_view

        p = sess.config.pattern
        if p.coding != "gray_phase":
            # calibration is its own capture: decode-at-corners needs
            # row+column gray_phase coding whatever the scan coding is
            p = dataclasses.replace(p, coding="gray_phase")
        if p.row_phase_steps == 0:
            # projector calibration needs sub-pixel rows: add row coding
            p = dataclasses.replace(p, row_gray_bits=max(p.row_gray_bits, 5),
                                    row_phase_steps=max(p.phase_steps, 4))
        whites, stacks = [], []
        for i, (R, t) in enumerate(board_poses(
                8, c.board_cols, c.board_rows, c.square_size, seed=0)):
            bv = render_board_view(
                cam_true, proj_true, p, R, t,
                c.board_cols, c.board_rows, c.square_size,
                sess.config.cam_height, sess.config.cam_width,
                noise_std=args.noise_px * 0.01, generator=_generator(dev, i))
            whites.append(bv.white_image)
            stacks.append(bv.scan.frames)
        res = calibrate_from_images(
            whites, stacks, c.board_cols, c.board_rows, c.square_size, p,
            lm_iters=c.lm_iters)
        st = res.stereo
    sess.set_calibration(st.cam, st.proj, {"rms": float(st.rms)})
    print(f"calibrated: joint rms {float(st.rms):.4f} px "
          f"-> {args.session}/calibration.json")


def cmd_reconstruct(args):
    sess = Session(args.session, device=args.device)
    t0 = time.time()
    accumulate = getattr(args, "accumulate", False)
    cloud = sess.reconstruct(args.index, fused=not args.no_fused,
                             spatial_iters=args.spatial_iters,
                             accumulate=accumulate)
    n = int(cloud.mask.sum())          # waits for the card
    print(f"scan {args.index}: {n} valid points in "
          f"{(time.time()-t0)*1e3:.1f} ms -> {args.session}/clouds/")
    if accumulate:
        from slr_torch.io import load_stage
        d = load_stage(sess.root / "clouds" / f"scan_{args.index:03d}.npz")
        print(f"projector-grid accumulation: "
              f"{int(d['acc_mask'].sum())} occupied cells")
    if args.ply:
        from slr_torch.io import write_ply
        out = f"{args.session}/clouds/scan_{args.index:03d}.ply"
        write_ply(out, cloud.points, mask=cloud.mask,
                  colors=cloud.colors[..., None].expand(*cloud.colors.shape, 3))
        print(f"wrote {out}")


def cmd_register(args):
    sess = Session(args.session, device=args.device)
    reg = sess.register(use_features=not args.no_features,
                        loop_closures=not getattr(args, "no_loop_closures", False))
    print(f"registered {sess.cloud_count()} scans; "
          f"icp rms {np.round(reg.icp_rms.cpu().numpy(), 4).tolist()}, "
          f"pose-graph rms {float(reg.pg_rms):.5f}")


def cmd_fuse(args):
    sess = Session(args.session, device=args.device)
    out = sess.fuse()
    print(f"fused model -> {out}")
    if getattr(args, "mesh", False):
        out = sess.fuse_mesh(voxel=args.voxel)
        print(f"fused TSDF mesh -> {out}")


def cmd_demo(args):
    """Full synthetic end-to-end: calibrate, then 3 scans -> reconstruct ->
    register -> fuse.

    --pixel-tiles/--map-blocks write a DistConfig into the session, so a
    job of that many ranks takes the sharded routes: pixel-tile sharded
    reconstruction, batched registration and the distributed Schur BA over
    the map blocks. A smaller job runs every stage unsharded on each rank
    (``mesh_fallback``)."""
    ns = argparse.Namespace
    coding = getattr(args, "coding", "gray_phase")
    pixel_tiles = getattr(args, "pixel_tiles", 1)
    map_blocks = getattr(args, "map_blocks", 1)
    if coding != "gray_phase" or pixel_tiles * map_blocks > 1:
        from slr_torch.config import DistConfig, PatternConfig

        cfg = Session(args.out, device=args.device).config
        if coding != "gray_phase":
            pat = (PatternConfig(coding="multifreq", phase_steps=4)
                   if coding == "multifreq"
                   else PatternConfig(phase_steps=0))   # "gray": code-only
            cfg = dataclasses.replace(cfg, pattern=pat)
        cfg = dataclasses.replace(
            cfg, dist=DistConfig(pixel_tiles=pixel_tiles, map_blocks=map_blocks))
        Session(args.out, cfg, device=args.device)
    cmd_calibrate(ns(session=args.out, device=args.device, noise_px=0.0))
    for pose in range(args.scans):
        cmd_scan(ns(session=args.out, device=args.device, scene="bumps", pose=pose,
                    noise=0.005))
        cmd_reconstruct(ns(session=args.out, device=args.device, index=pose,
                           no_fused=False, spatial_iters=0, ply=False))
    cmd_register(ns(session=args.out, device=args.device, no_features=args.no_features))
    cmd_fuse(ns(session=args.out, device=args.device))


def cmd_stereo_demo(args):
    """Two-camera rig demo: render both views of the spheres scene,
    reconstruct through the projector-space rendezvous (no projector
    calibration in the geometry), report the RMS against the truth and
    write the PLY."""
    from slr_torch.config import PatternConfig, ScanConfig
    from slr_torch.geom.camera import pixel_to_ray
    from slr_torch.io import write_ply
    from slr_torch.synth import render_scan, spheres_scene, two_camera_rig

    H, W = args.cam_h, args.cam_w
    cfg = PatternConfig(proj_width=512, proj_height=384, gray_bits=6,
                        row_gray_bits=5, phase_steps=3, row_phase_steps=3)
    sess = Session(args.out, ScanConfig(pattern=cfg, cam_width=W, cam_height=H),
                   device=args.device)
    dev = sess.device
    cam1, cam2, proj = two_camera_rig(cam_w=W, cam_h=H, proj_w=512, proj_h=384,
                                      device=dev)
    sess.set_calibration(cam1, proj, cam2=cam2)
    scans = []
    for i, cam in enumerate((cam1, cam2)):
        depth = spheres_scene(cam, H, W)
        scans.append(render_scan(cam, proj, depth, cfg, noise_std=0.003,
                                 generator=_generator(dev, i), cast_shadows=True))
    sess.add_scan(scans[0].frames, frames2=scans[1].frames)
    cloud = sess.reconstruct(0)
    # the merge organizes the cloud on the PROJECTOR grid; the projector is
    # a Camera, so the truth is the scene depth from its viewpoint (the
    # first surface hit along each projector ray)
    depth_p = spheres_scene(sess.proj, cfg.proj_height, cfg.proj_width)
    vg = torch.arange(cfg.proj_height, dtype=torch.float32, device=dev)[:, None]
    ug = torch.arange(cfg.proj_width, dtype=torch.float32, device=dev)[None, :]
    o_p, d_p = pixel_to_ray(sess.proj, *torch.broadcast_tensors(ug, vg))
    dz = torch.einsum("j,...j->...", sess.proj.R[2], d_p)
    pts_true = o_p + (depth_p / dz)[..., None] * d_p
    err = torch.linalg.norm(cloud.points - pts_true, dim=-1)[cloud.mask]
    rms = float(torch.sqrt(torch.mean(err ** 2))) if err.numel() else float("nan")
    out = Path(args.out) / "stereo.ply"
    write_ply(out, cloud.points.reshape(-1, 3), mask=cloud.mask.reshape(-1))
    print(f"two-camera cloud: {int(cloud.mask.sum())} px, RMS {rms:.4f} mm "
          f"-> {out}")


def cmd_import_scan(args):
    """Ingest a scan folder (one image per pattern) into the session: the
    real-data entry point in place of camera capture."""
    from slr_torch.io import load_scan_folder

    frames = load_scan_folder(args.folder)
    sess = Session(args.session, device=args.device)
    idx = sess.add_scan(frames)
    print(f"imported {frames.shape[0]} frames "
          f"({frames.shape[1]}x{frames.shape[2]}) as scan {idx}")


def cmd_export_scan(args):
    from slr_torch.io import save_scan_folder

    sess = Session(args.session, device=args.device)
    frames = sess.load_scan(args.index)
    paths = save_scan_folder(args.folder, frames, fmt=args.format)
    print(f"wrote {len(paths)} frames -> {args.folder}")


def cmd_export_calib(args):
    """Write the session calibration as cv::FileStorage YAML for OpenCV
    tooling."""
    from slr_torch.io import save_calibration_opencv

    sess = Session(args.session, device=args.device)
    if sess.cam is None:
        raise SystemExit("session has no calibration — run calibrate first")
    save_calibration_opencv(args.out, sess.cam, sess.proj, sess.calib_meta)
    print(f"wrote OpenCV YAML calibration -> {args.out}")


def cmd_import_calib(args):
    from slr_torch.io import load_calibration_opencv

    cam, proj, meta = load_calibration_opencv(args.yaml, device=args.device)
    sess = Session(args.session, device=args.device)
    sess.set_calibration(cam, proj, dict(meta, source="opencv_yaml"))
    print(f"imported calibration from {args.yaml} -> "
          f"{args.session}/calibration.json")


def cmd_view(args):
    """Render point-cloud preview images (splatted on the session's
    device)."""
    from slr_torch.io import read_ply
    from slr_torch.pipeline.viewer import render_turntable

    sess = Session(args.session, device=args.device)
    if args.cloud == "fused":
        pts, cols, _ = read_ply(f"{args.session}/fused.ply")
    else:
        c = sess.load_cloud(int(args.cloud))
        pts = c.points[c.mask]
        cols = c.colors[c.mask][:, None].expand(-1, 3)
    out = args.out or f"{args.session}/preview"
    outs = render_turntable(pts, cols, out, frames=args.frames, size=args.size,
                            device=sess.device)
    print(f"wrote {len(outs)} view(s): {outs[0]}{' ...' if len(outs)>1 else ''}")


def cmd_bench(args):
    raise SystemExit("slr_torch.cli bench: the port's benchmark comes with its first "
                     "benchmark PR (ROADMAP queue 1, item 1); bench.py is the JAX "
                     "reference's and is not run from here")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="slr_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device every command runs on (default: the card; "
                         "'cpu' for the CPU)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="multi-process job coordinator (rank 0 listens there; or an "
                         "init-method URL such as file:///path/store)")
    ap.add_argument("--num-procs", type=int, default=None, dest="num_procs",
                    help="total process count of the distributed job")
    ap.add_argument("--proc-id", type=int, default=None, dest="proc_id",
                    help="this process's rank in [0, num-procs)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("scan", help="synthetic capture into a session")
    p.add_argument("--session", required=True)
    p.add_argument("--scene", default="bumps", choices=["bumps", "sphere"])
    p.add_argument("--pose", type=int, default=0)
    p.add_argument("--noise", type=float, default=0.005)
    p.set_defaults(fn=cmd_scan)

    p = sub.add_parser("calibrate", help="Zhang calibration of the rig")
    p.add_argument("--session", required=True)
    p.add_argument("--noise-px", type=float, default=0.0, dest="noise_px")
    p.add_argument("--synthetic-corners", action="store_true",
                   dest="synthetic_corners",
                   help="skip detection/decode; feed analytically projected "
                        "corner coordinates straight to the solvers")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("reconstruct", help="decode+triangulate one scan")
    p.add_argument("--session", required=True)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--no-fused", action="store_true")
    p.add_argument("--spatial-iters", type=int, default=0)
    p.add_argument("--ply", action="store_true")
    p.add_argument("--accumulate", action="store_true",
                   help="also bin the cloud onto the projector column grid")
    p.set_defaults(fn=cmd_reconstruct)

    p = sub.add_parser("register", help="align all reconstructed scans")
    p.add_argument("--session", required=True)
    p.add_argument("--no-features", action="store_true")
    p.add_argument("--no-loop-closures", action="store_true",
                   help="chain odometry only (skip last<->first/skip edges)")
    p.set_defaults(fn=cmd_register)

    p = sub.add_parser("fuse", help="merge registered scans into one model")
    p.add_argument("--mesh", action="store_true",
                   help="also TSDF-fuse and export a triangle mesh (OBJ)")
    p.add_argument("--voxel", type=float, default=2.0,
                   help="TSDF voxel size (mm)")
    p.add_argument("--session", required=True)
    p.set_defaults(fn=cmd_fuse)

    p = sub.add_parser("demo", help="full synthetic end-to-end run")
    p.add_argument("--out", default="slr_demo")
    p.add_argument("--scans", type=int, default=3)
    p.add_argument("--no-features", action="store_true")
    p.add_argument("--coding", default="gray_phase",
                   choices=["gray_phase", "gray", "multifreq"],
                   help="temporal coding family (gray = Gray code only)")
    p.add_argument("--pixel-tiles", type=int, default=1, dest="pixel_tiles",
                   help="shard image rows over this many ranks")
    p.add_argument("--map-blocks", type=int, default=1, dest="map_blocks",
                   help="shard scans/landmarks over this many ranks")
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("stereo-demo",
                       help="two-camera rig end-to-end (no projector "
                            "calibration in the triangulation)")
    p.add_argument("--out", default="slr_stereo")
    p.add_argument("--cam-w", type=int, default=512, dest="cam_w")
    p.add_argument("--cam-h", type=int, default=384, dest="cam_h")
    p.set_defaults(fn=cmd_stereo_demo)

    p = sub.add_parser("import-scan", help="ingest a scan image folder")
    p.add_argument("--session", required=True)
    p.add_argument("--folder", required=True)
    p.set_defaults(fn=cmd_import_scan)

    p = sub.add_parser("export-scan", help="write a scan as an image folder")
    p.add_argument("--session", required=True)
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--folder", required=True)
    p.add_argument("--format", default="pgm", choices=["pgm", "png"])
    p.set_defaults(fn=cmd_export_scan)

    p = sub.add_parser("export-calib", help="export cv::FileStorage YAML")
    p.add_argument("--session", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_export_calib)

    p = sub.add_parser("import-calib", help="import cv::FileStorage YAML")
    p.add_argument("--session", required=True)
    p.add_argument("--yaml", required=True)
    p.set_defaults(fn=cmd_import_calib)

    p = sub.add_parser("view", help="render point-cloud preview images")
    p.add_argument("--session", required=True)
    p.add_argument("--cloud", default="fused",
                   help="'fused' or a scan index")
    p.add_argument("--out", default=None, help="output path prefix")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--size", type=int, default=640)
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("bench", help="the benchmark harness (not yet ported)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    if args.num_procs and args.num_procs > 1:
        from slr_torch.dist import init_distributed

        dev = torch.device(args.device)
        args.device = str(init_distributed(
            coordinator=args.coordinator, num_processes=args.num_procs,
            process_id=args.proc_id, device=None if dev == torch.device("cuda") else dev))
        try:
            args.fn(args)
        finally:
            torch.distributed.destroy_process_group()
        return
    args.fn(args)


if __name__ == "__main__":
    main()
