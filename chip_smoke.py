"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the repository root: builds the port's CUDA kernels (K1 and K2 of
``slr_torch/kernels/csrc/fused_scan.cu``) with nvcc, holds every branch to
its plain PyTorch version on the card, and drives each scan path through
the entry point a user calls (``DenseReconstructor``, ``slr_torch.entry``)
on the config-3 rig (1280x1024 camera, 1024x768 projector): float32,
uint8 and uint16 ingest, Gray only, row+column midpoint with and without
row phase, multifreq, ``decode_only`` on a posed camera, and the HDR
exposure bracket (K2, both fusions). Each path's cloud is checked against
the synthetic ground truth and its launches counted; then the kernels,
their plain versions and the scan are timed with CUDA events. Each phase
prints one JSON line; the last line is ``{"ok": true, "device": {...}}``.
Any failed check ends the run with a traceback and a non-zero exit, as
does a machine without a CUDA device. Imports nothing of JAX.
"""

import json
import math
import statistics
import subprocess
import time

import torch

# config-3 scene
CAM_W, CAM_H = 1280, 1024
PROJ_W, PROJ_H = 1024, 768
# kernel-versus-plain tolerances; both sides are float32, so they differ
# only by FMA contraction in nvcc's code, the order of float sums and the
# device atan2f. Those can flip a Gray bit or a fringe order on the rare
# pixel sitting exactly on a code edge, hence fractions of pixels and not
# only maxima.
MASK_DISAGREE_MAX = 1e-3   # fraction of pixels whose mask differs
XP_TOL = 1e-3              # px, x_p and (rows coded) y_p, on mutually valid pixels ...
XP_OUTLIER_MAX = 1e-4      # ... for all but this fraction of them
POINTS_TOL = 1e-2          # mm, on the pixels whose x_p (and y_p) agree
QUALITY_TOL = 1e-5         # modulation, every pixel
RMS_GATE_MM = 0.1          # against ground truth (config 3, float32 and uint8)
TIMED_RUNS = 20
HBM_PEAK_TBS = 3.35        # H100 SXM data sheet
HDR_GAINS = (1.0, 3.2, 10.0)
PROJ_DIST = [-0.08, 0.02, 0.001, -0.001, 0.0]


def emit(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def agreement(k, p, rows=False, decode_only=False):
    """Kernel output ``k`` against plain output ``p`` (FusedScanOut).
    ``rows``: y_p is decoded and compared like x_p; else it must be 0."""
    mk, mp = k.mask > 0.5, p.mask > 0.5
    both = mk & mp
    dx = (k.x_p - p.x_p).abs()
    dy = (k.y_p - p.y_p).abs()
    off = (dx > XP_TOL) | (dy > XP_TOL) if rows else dx > XP_TOL
    agree = both & ~off
    n_both = int(both.sum())
    dpts = (k.points - p.points).abs().amax(dim=0)
    a = {
        "mask_disagree": float((mk ^ mp).float().mean()),
        "xp_outliers": float((both & off).sum()) / max(n_both, 1),
        "xp_max_abs_err_agreeing": float(dx[agree].max()),
        "points_max_abs_err": float(dpts[agree].max()),
        "quality_max_abs_err": float((k.quality - p.quality).abs().max()),
        "valid_px": n_both,
    }
    if rows:
        a["yp_max_abs_err_agreeing"] = float(dy[agree].max())
    else:
        a["y_p_max_abs"] = max(float(k.y_p.abs().max()), float(p.y_p.abs().max()))
    if decode_only:
        a["points_max_abs"] = float(k.points.abs().max())
    return a


def check_agreement(a, where):
    check(a["mask_disagree"] <= MASK_DISAGREE_MAX, f"{where} mask {a}")
    check(a["xp_outliers"] <= XP_OUTLIER_MAX, f"{where} x_p/y_p outliers {a}")
    check(a["points_max_abs_err"] <= POINTS_TOL, f"{where} points {a}")
    check(a["quality_max_abs_err"] <= QUALITY_TOL, f"{where} quality {a}")
    check(a.get("y_p_max_abs", 0.0) == 0.0, f"{where} y_p {a}")
    check(a.get("points_max_abs", 0.0) == 0.0, f"{where} decode_only points {a}")


def rms_vs_truth(points, mask, scan):
    """RMS (mm) of (H, W, 3) points against the ground truth, and the count
    of pixels valid in both."""
    valid = mask & scan.mask_true
    err = torch.linalg.norm(points - scan.points_true, dim=-1)[valid]
    return math.sqrt(float((err * err).mean())), int(valid.sum())


def cuda_ms(fn, runs=TIMED_RUNS, warmup=3):
    """Per-run device time of ``fn`` with CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def host_ms(fn, runs=TIMED_RUNS):
    """Median host time of ``fn`` from an idle card: the time to enqueue,
    plus any wait ``fn`` makes for the device."""
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def nvidia_smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """nvcc -Xptxas -v's log as {kernel instantiation: registers and spills}."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = (out.get(name, "") + " " + ln.split(":", 1)[-1].strip()).strip()
    return out


def main():
    # phase 1: the card
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on an NVIDIA GPU")
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)

    from slr_torch.codec.patterns import decode_stack
    from slr_torch.config import DecodeConfig, PatternConfig
    from slr_torch.entry import entry
    from slr_torch.geom.camera import make_camera
    from slr_torch.kernels import fused_scan as fs
    from slr_torch.kernels.build import build_library
    from slr_torch.pipeline.reconstruct import (
        DenseReconstructor, accumulate_by_projector)
    from slr_torch.synth.render import default_rig, quantize_frames, render_scan
    from slr_torch.synth.scene import bumps_depth, checker_albedo

    kernel = fs.fused_decode_triangulate
    kernel_hdr = fs.fused_decode_triangulate_hdr
    dev = torch.device("cuda")
    dec = DecodeConfig()
    errs = {"k1": [], "k2": []}   # points_max_abs_err of every comparison

    def counted(fn):
        """Run ``fn`` with both launch counts set to 0 just before; returns
        (result, K1 launches, K2 launches) read just after."""
        kernel.launches = kernel_hdr.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, kernel.launches, kernel_hdr.launches

    def versus_plain(frames, cam, proj, cfg, where, **kw):
        """K1 on the card against its plain version on the same inputs."""
        a = agreement(kernel(frames, cam, proj, cfg, dec, **kw),
                      fs.fused_decode_triangulate_reference(
                          frames, cam, proj, cfg, dec, **kw),
                      rows=cfg.row_gray_bits > 0,
                      decode_only=kw.get("decode_only", False))
        check_agreement(a, where)
        errs["k1"].append(a["points_max_abs_err"])
        return a

    def k1_path(name, frames, cam, proj, cfg, scan, rms_gate, **fields):
        """Kernel vs plain, then the path through DenseReconstructor: exactly
        one K1 launch, finite points of the right shape, RMS under the gate."""
        a = versus_plain(frames, cam, proj, cfg, name)
        model = DenseReconstructor(cam, proj, cfg).to(dev)
        cloud, n1, n2 = counted(lambda: model(frames))
        check((n1, n2) == (1, 0), f"{name}: K1/K2 launched {n1}/{n2} times")
        check(tuple(cloud.points.shape) == (CAM_H, CAM_W, 3)
              and bool(torch.isfinite(cloud.points).all()), f"{name} points")
        rms, n = rms_vs_truth(cloud.points, cloud.mask, scan)
        check(rms <= rms_gate, f"{name}: RMS {rms} mm > {rms_gate}")
        emit(name, launches=n1, rms_mm=rms, rms_gate_mm=rms_gate,
             valid_points=n, frames=list(frames.shape), dtype=str(frames.dtype),
             kernel_vs_plain=a, **fields)
        return n1

    # phase 2: build the kernels from the checkout's sources (set-up time)
    t0 = time.perf_counter()
    lib_path, log = build_library("fused_scan")
    fs._library()
    emit("build", setup_s=time.perf_counter() - t0, library=lib_path.name,
         ptxas=ptxas_summary(log))

    # phase 3: render the config-3 scene on the card
    t0 = time.perf_counter()
    cam, proj = default_rig(CAM_W, CAM_H)            # on the host
    cfg = PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=7,
                        phase_steps=4)
    depth = bumps_depth(CAM_H, CAM_W, base=480.0, amp=30.0, device=dev)
    gen = torch.Generator(device="cuda").manual_seed(0)
    scan = render_scan(cam.to(dev), proj.to(dev), depth, cfg, noise_std=0.005,
                       generator=gen)
    frames = scan.frames.contiguous()
    torch.cuda.synchronize()
    emit("render", frames=list(frames.shape), dtype=str(frames.dtype),
         s=time.perf_counter() - t0)

    # phase 4: K1 (float32 column plane) against its plain version, full
    # size and ragged
    cam_d, proj_d = cam.to(dev), proj.to(dev)
    full = versus_plain(frames, cam_d, proj_d, cfg, "1280x1024")
    rcam, rproj = default_rig(cam_w=300, cam_h=215, proj_w=256, proj_h=192,
                              baseline=150.0, toe_in_deg=14.0, device=dev)
    rcfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                         phase_steps=4)
    rscan = render_scan(rcam, rproj, bumps_depth(215, 300, base=480.0,
                                                 amp=20.0, device=dev), rcfg)
    ragged = versus_plain(rscan.frames, rcam, rproj, rcfg, "300x215")
    check(ragged["valid_px"] > 0.3 * 300 * 215, f"300x215 coverage {ragged}")
    emit("kernel_vs_plain", full=full, ragged=ragged)

    # phase 5: the main path, through the module a user would call
    model = DenseReconstructor(cam, proj, cfg).to(dev)
    check(model.cam_R.device.type == "cuda", "calibration buffers on the card")
    cloud, launches, n2 = counted(lambda: model(frames))
    check((launches, n2) == (1, 0),
          f"reconstruct_dense launched K1/K2 {launches}/{n2} times")
    check(not bool(torch.isnan(cloud.points).any()), "NaN in points")
    check(tuple(cloud.points.shape) == (CAM_H, CAM_W, 3), "points shape")
    rms, n_valid = rms_vs_truth(cloud.points, cloud.mask, scan)
    check(rms <= RMS_GATE_MM, f"RMS {rms} mm > {RMS_GATE_MM}")
    acc_pts, acc_mask, acc_col = accumulate_by_projector(cloud, PROJ_W)
    check(tuple(acc_pts.shape) == (CAM_H, PROJ_W, 3)
          and tuple(acc_mask.shape) == (CAM_H, PROJ_W)
          and tuple(acc_col.shape) == (CAM_H, PROJ_W)
          and bool(torch.isfinite(acc_pts).all()), "accumulate_by_projector")
    emit("reconstruct_dense", launches=launches, rms_mm=rms,
         valid_points=n_valid, projector_cells=int(acc_mask.sum()))

    # phase 6: the port's entry point
    forward, (small,) = entry(dev)
    (pts, mask), n1, n2 = counted(lambda: forward(small))
    check(bool(torch.isfinite(pts).all()) and float(mask.float().mean()) > 0.3,
          "entry() forward")
    check((n1, n2) == (1, 0), f"entry() launched K1/K2 {n1}/{n2} times")
    launches += n1
    emit("entry", points=list(pts.shape), valid_fraction=float(mask.float().mean()),
         launches=n1)

    # phase 7: K1 on raw 8-bit camera frames: 20 B + 28 B per pixel
    frames8 = quantize_frames(frames)
    launches += k1_path("k1_uint8", frames8, cam_d, proj_d, cfg, scan, RMS_GATE_MM,
                        bytes=(20 + 28) * CAM_H * CAM_W)

    # phase 8: K1 on 12-bit data in a uint16 container, ragged scene
    m12 = (1 << 12) - 1
    f12 = torch.clamp(torch.round(rscan.frames * m12), 0, m12).to(torch.uint16)
    a12 = versus_plain(f12, rcam, rproj, rcfg, "uint16 300x215",
                       bit_depth=12)
    ref = decode_stack(rscan.frames, rcfg, dec)
    (out12, n1, n2) = counted(lambda: kernel(f12, rcam, rproj, rcfg, dec,
                                             bit_depth=12))
    check((n1, n2) == (1, 0), f"uint16: K1/K2 launched {n1}/{n2} times")
    md = float(((out12.mask > 0.5) ^ ref.mask).float().mean())
    check(md < 1e-2, f"uint16 mask vs the float32 decode: {md}")
    launches += n1
    emit("k1_uint16_bit_depth_12", launches=n1, kernel_vs_plain=a12,
         mask_vs_float32_decode=md)

    # phase 9: Gray only (config 1), half-stripe centres by design
    cfg1 = PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=7,
                         phase_steps=0)
    scan1 = render_scan(cam_d, proj_d, depth, cfg1)
    launches += k1_path("k1_gray_only", scan1.frames, cam_d, proj_d, cfg1, scan1, 5.0)

    # phases 10-11: row+column midpoint, full projector distortion; Gray
    # rows, then rows with their own 4-step phase (noiseless)
    cam_m, proj_m = default_rig(CAM_W, CAM_H, proj_dist=PROJ_DIST, device=dev)
    cfgm = PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=7,
                         row_gray_bits=6, phase_steps=4)
    scanm = render_scan(cam_m, proj_m, depth, cfgm)
    launches += k1_path("k1_midpoint", scanm.frames, cam_m, proj_m, cfgm, scanm, 2.0)
    cfgr = PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=7,
                         row_gray_bits=6, phase_steps=4, row_phase_steps=4)
    scanr = render_scan(cam_m, proj_m, depth, cfgr)
    launches += k1_path("k1_midpoint_row_phase", scanr.frames, cam_m, proj_m,
                        cfgr, scanr, 0.01)

    # phase 12: multifreq hierarchical phase (no Gray frames)
    cfgmf = PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H,
                          coding="multifreq", phase_steps=4, mf_levels=3,
                          mf_ratio=8.0)
    scanmf = render_scan(cam_d, proj_d, depth, cfgmf, noise_std=0.005,
                         generator=torch.Generator(device="cuda").manual_seed(2))
    launches += k1_path("k1_multifreq", scanmf.frames, cam_d, proj_d, cfgmf,
                        scanmf, RMS_GATE_MM)

    # phase 13: decode_only on a posed camera (camera 2 of a two-camera rig:
    # R != I, t != 0), no projector model; uint8 row+column frames
    cam2 = make_camera(cam.fx, cam.fy, cam.cx, cam.cy, R=proj.R, t=proj.t,
                       device=dev)
    fr8 = quantize_frames(scanr.frames)
    ado = versus_plain(fr8, cam2, None, cfgr, "decode_only",
                       decode_only=True)
    (odo, n1, n2) = counted(lambda: kernel(fr8, cam2, None, cfgr, dec,
                                           decode_only=True))
    check((n1, n2) == (1, 0), f"decode_only: K1/K2 launched {n1}/{n2} times")
    check(float(odo.points.abs().max()) == 0.0, "decode_only points are 0")
    check(float(odo.mask.mean()) > 0.3, "decode_only coverage")
    launches += n1
    emit("k1_decode_only", launches=n1, kernel_vs_plain=ado,
         valid_fraction=float(odo.mask.mean()))

    # phase 14: the HDR bracket (K2): 21x albedo range, three independent
    # uint8 captures at three gains
    albedo = checker_albedo(CAM_H, CAM_W, cells=8, lo=0.035, hi=0.75, device=dev)
    scan_h = render_scan(cam_d, proj_d, depth, cfg, albedo=albedo)
    hgen = torch.Generator(device="cuda").manual_seed(9)
    bracket = torch.stack([quantize_frames(torch.clamp(
        scan_h.frames * g + 0.003 * torch.randn(
            scan_h.frames.shape, generator=hgen, device=dev), 0.0, 1.0))
        for g in HDR_GAINS])
    hdr = {}
    for fuse in ("sum", "select"):
        a = agreement(kernel_hdr(bracket, cam_d, proj_d, cfg, dec, fuse=fuse),
                      fs.fused_decode_triangulate_hdr_reference(
                          bracket, cam_d, proj_d, cfg, dec, fuse=fuse))
        check_agreement(a, f"hdr {fuse}")
        errs["k2"].append(a["points_max_abs_err"])
        (o, n1, n2) = counted(lambda: kernel_hdr(bracket, cam_d, proj_d, cfg,
                                                 dec, fuse=fuse))
        check((n1, n2) == (0, 1), f"hdr {fuse}: K1/K2 launched {n1}/{n2} times")
        rms_f, n_f = rms_vs_truth(o.points.movedim(0, -1), o.mask > 0.5, scan_h)
        check(rms_f <= RMS_GATE_MM, f"hdr {fuse}: RMS {rms_f} mm")
        hdr[fuse] = dict(kernel_vs_plain=a, rms_mm=rms_f, valid_points=n_f)
    # the best single exposure under the bracket's own gates (K2 on that
    # exposure alone: a saturated white frame makes a pixel unusable), and
    # under K1's, which keeps clipped fringes on saturated cells
    best_single = max(int((kernel_hdr(bracket[e:e + 1], cam_d, proj_d, cfg,
                                      dec).mask > 0.5).sum())
                      for e in range(len(HDR_GAINS)))
    best_single_k1 = max(int((kernel(bracket[e], cam_d, proj_d, cfg,
                                     dec).mask > 0.5).sum())
                         for e in range(len(HDR_GAINS)))
    model = DenseReconstructor(cam, proj, cfg).to(dev)
    cloud_h, n1, launches_hdr = counted(lambda: model(bracket))
    check((n1, launches_hdr) == (0, 1),
          f"HDR DenseReconstructor launched K1/K2 {n1}/{launches_hdr} times")
    check(tuple(cloud_h.points.shape) == (CAM_H, CAM_W, 3)
          and bool(torch.isfinite(cloud_h.points).all()), "hdr points")
    rms_h, n_h = rms_vs_truth(cloud_h.points, cloud_h.mask, scan_h)
    check(rms_h <= RMS_GATE_MM, f"HDR scan RMS {rms_h} mm > {RMS_GATE_MM}")
    coverage = int(cloud_h.mask.sum()) / max(best_single, 1)
    check(coverage > 1.3, f"bracket coverage {coverage}x the best single exposure")
    hdr_bytes = (len(HDR_GAINS) * (2 + cfg.phase_steps) + 2 * cfg.gray_bits
                 + 7 * 4) * CAM_H * CAM_W
    emit("k2_hdr_bracket", launches=launches_hdr, rms_mm=rms_h, valid_points=n_h,
         coverage_vs_best_single=coverage, best_single_valid=best_single,
         coverage_vs_best_single_k1=int(cloud_h.mask.sum()) / best_single_k1,
         bracket=list(bracket.shape), dtype=str(bracket.dtype),
         fuse=hdr, bytes=hdr_bytes)

    # phase 15: times, in turns (plain, kernel, scan, scan, kernel, plain)
    # for K1 on float32 and on uint8 and for K2 (sum)
    params = fs.scan_params(cam_d, proj_d, cfg, dec, (1.0, 1e4), 8, CAM_H, CAM_W)
    params8 = fs.scan_params(cam_d, proj_d, cfg, dec, (1.0, 1e4), 8, CAM_H,
                             CAM_W, dtype=torch.uint8)
    params_h = fs.scan_params(cam_d, proj_d, cfg, dec, (1.0, 1e4), 8, CAM_H,
                              CAM_W, dtype=torch.uint8, exposures=len(HDR_GAINS))
    model = DenseReconstructor(cam, proj, cfg).to(dev)
    runs = {
        "plain": lambda: fs.fused_decode_triangulate_reference(
            frames, cam_d, proj_d, cfg, dec),
        "kernel": lambda: fs.launch_fused_scan(frames, params),
        "scan": lambda: model(frames),
        "plain_uint8": lambda: fs.fused_decode_triangulate_reference(
            frames8, cam_d, proj_d, cfg, dec),
        "kernel_uint8": lambda: fs.launch_fused_scan(frames8, params8),
        "scan_uint8": lambda: model(frames8),
        "plain_hdr": lambda: fs.fused_decode_triangulate_hdr_reference(
            bracket, cam_d, proj_d, cfg, dec),
        "kernel_hdr": lambda: fs.launch_fused_scan_hdr(bracket, params_h),
        "scan_hdr": lambda: model(bracket),
    }
    times = {k: [] for k in runs}
    for sfx in ("", "_uint8", "_hdr"):
        for name in ("plain", "kernel", "scan", "scan", "kernel", "plain"):
            times[name + sfx] += cuda_ms(runs[name + sfx])
    ms = {k: statistics.median(v) for k, v in times.items()}
    spread = {f"{k}_ms_spread": [min(v), max(v)] for k, v in times.items()}
    moved = {"": (4 * cfg.num_frames + 7 * 4) * CAM_H * CAM_W,
             "_uint8": (cfg.num_frames + 7 * 4) * CAM_H * CAM_W,
             "_hdr": hdr_bytes}
    gbs = {f"kernel{s}_gb_s": b / (ms["kernel" + s] * 1e-3) / 1e9
           for s, b in moved.items()}
    host = {f"{k}_host_ms": host_ms(fn) for k, fn in (
        ("scan_params", lambda: fs.scan_params(cam_d, proj_d, cfg, dec,
                                               (1.0, 1e4), 8, CAM_H, CAM_W)),
        ("launch", runs["kernel"]), ("scan", runs["scan"]))}
    emit("timing", card=card, runs_each=len(times["kernel"]),
         **{f"{k}_ms": v for k, v in ms.items()}, **host, **spread,
         **{f"kernel{s}_bytes": b for s, b in moved.items()}, **gbs,
         hbm_peak_gb_s=HBM_PEAK_TBS * 1e3,
         **{k.replace("gb_s", "hbm_share"): v / (HBM_PEAK_TBS * 1e3)
            for k, v in gbs.items()},
         after=nvidia_smi("clocks.sm,power.draw,temperature.gpu"))

    print(json.dumps({"kernels": [{
        "name": "fused_decode_triangulate",
        "route": "cuda",
        "source": "slr_torch/kernels/csrc/fused_scan.cu",
        "replaces": "slr/kernels/fused_scan.py:80",
        "branches": ["float32", "uint8", "uint16+bit_depth", "gray_only",
                     "midpoint", "midpoint+row_phase", "multifreq",
                     "decode_only"],
        "launches": launches,
        "max_abs_err": max(errs["k1"]),
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "ms_uint8": ms["kernel_uint8"],
        "plain_ms_uint8": ms["plain_uint8"],
    }, {
        "name": "fused_decode_triangulate_hdr",
        "route": "cuda",
        "source": "slr_torch/kernels/csrc/fused_scan.cu",
        "replaces": "slr/kernels/fused_scan.py:522",
        "branches": ["sum", "select"],
        "launches": launches_hdr,
        "max_abs_err": max(errs["k2"]),
        "ms": ms["kernel_hdr"],
        "plain_ms": ms["plain_hdr"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
