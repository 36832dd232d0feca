"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the repository root: builds the port's CUDA kernel from
``slr_torch/kernels/csrc`` with nvcc, holds it to its plain PyTorch version
on the card, drives the config-3 dense-scan path (1280x1024 camera, 20-frame
float32 stack) through ``DenseReconstructor`` and ``slr_torch.entry``,
checks the cloud against the synthetic ground truth, and times the kernel,
its plain version and the whole scan with CUDA events. Each phase prints one
JSON line; the last line is ``{"ok": true, "device": {...}}``. Any failed
check ends the run with a traceback and a non-zero exit, as does a machine
without a CUDA device. Imports nothing of JAX.
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
XP_TOL = 1e-3              # px, on mutually valid pixels ...
XP_OUTLIER_MAX = 1e-4      # ... for all but this fraction of them
POINTS_TOL = 1e-2          # mm, on the pixels whose x_p agrees
QUALITY_TOL = 1e-5         # modulation, every pixel
RMS_GATE_MM = 0.1          # against ground truth
TIMED_RUNS = 20
HBM_PEAK_TBS = 3.35        # H100 SXM data sheet


def emit(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def agreement(k, p):
    """Kernel output ``k`` against plain output ``p`` (FusedScanOut)."""
    mk, mp = k.mask > 0.5, p.mask > 0.5
    both = mk & mp
    dx = (k.x_p - p.x_p).abs()
    agree = both & (dx <= XP_TOL)
    n_both = int(both.sum())
    dpts = (k.points - p.points).abs().amax(dim=0)
    return {
        "mask_disagree": float((mk ^ mp).float().mean()),
        "xp_outliers": float((both & (dx > XP_TOL)).sum()) / max(n_both, 1),
        "xp_max_abs_err_agreeing": float(dx[agree].max()),
        "points_max_abs_err": float(dpts[agree].max()),
        "quality_max_abs_err": float((k.quality - p.quality).abs().max()),
        "y_p_max_abs": float(k.y_p.abs().max()),
        "valid_px": n_both,
    }


def check_agreement(a, where):
    check(a["mask_disagree"] <= MASK_DISAGREE_MAX, f"{where} mask {a}")
    check(a["xp_outliers"] <= XP_OUTLIER_MAX, f"{where} x_p outliers {a}")
    check(a["points_max_abs_err"] <= POINTS_TOL, f"{where} points {a}")
    check(a["quality_max_abs_err"] <= QUALITY_TOL, f"{where} quality {a}")
    check(a["y_p_max_abs"] == 0.0, f"{where} y_p {a}")


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


def main():
    # phase 1: the card
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on an NVIDIA GPU")
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)

    from slr_torch.config import DecodeConfig, PatternConfig
    from slr_torch.entry import entry
    from slr_torch.kernels import fused_scan as fs
    from slr_torch.kernels.build import build_library
    from slr_torch.pipeline.reconstruct import (
        DenseReconstructor, accumulate_by_projector)
    from slr_torch.synth.render import default_rig, render_scan
    from slr_torch.synth.scene import bumps_depth

    kernel = fs.fused_decode_triangulate
    dev = torch.device("cuda")
    dec = DecodeConfig()

    # phase 2: build the kernel from the checkout's sources (set-up time)
    t0 = time.perf_counter()
    lib_path, log = build_library("fused_scan")
    fs._library()
    emit("build", setup_s=time.perf_counter() - t0, library=lib_path.name,
         ptxas=[ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln])

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

    # phase 4: kernel against its plain version, full size and ragged
    cam_d, proj_d = cam.to(dev), proj.to(dev)
    full = agreement(kernel(frames, cam_d, proj_d, cfg, dec),
                     fs.fused_decode_triangulate_reference(
                         frames, cam_d, proj_d, cfg, dec))
    check_agreement(full, "1280x1024")
    rcam, rproj = default_rig(cam_w=300, cam_h=215, proj_w=256, proj_h=192,
                              baseline=150.0, toe_in_deg=14.0, device=dev)
    rcfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                         phase_steps=4)
    rscan = render_scan(rcam, rproj, bumps_depth(215, 300, base=480.0,
                                                 amp=20.0, device=dev), rcfg)
    ragged = agreement(kernel(rscan.frames, rcam, rproj, rcfg, dec),
                       fs.fused_decode_triangulate_reference(
                           rscan.frames, rcam, rproj, rcfg, dec))
    check_agreement(ragged, "300x215")
    check(ragged["valid_px"] > 0.3 * 300 * 215, f"300x215 coverage {ragged}")
    emit("kernel_vs_plain", full=full, ragged=ragged)

    # phase 5: the main path, through the module a user would call
    model = DenseReconstructor(cam, proj, cfg).to(dev)
    check(model.cam_R.device.type == "cuda", "calibration buffers on the card")
    kernel.launches = 0
    cloud = model(frames)
    torch.cuda.synchronize()
    launches = kernel.launches
    check(launches == 1, f"reconstruct_dense launched the kernel {launches} times")
    check(not bool(torch.isnan(cloud.points).any()), "NaN in points")
    check(tuple(cloud.points.shape) == (CAM_H, CAM_W, 3), "points shape")
    valid = cloud.mask & scan.mask_true
    n_valid = int(valid.sum())
    err = torch.linalg.norm(cloud.points - scan.points_true, dim=-1)[valid]
    rms = math.sqrt(float((err * err).mean()))
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
    pts, mask = forward(small)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(pts).all()) and float(mask.float().mean()) > 0.3,
          "entry() forward")
    emit("entry", points=list(pts.shape), valid_fraction=float(mask.float().mean()))

    # phase 7: times, in turns (plain, kernel, scan, scan, kernel, plain)
    params = fs.scan_params(cam_d, proj_d, cfg, dec, (1.0, 1e4), 8, CAM_H, CAM_W)
    runs = {
        "plain": lambda: fs.fused_decode_triangulate_reference(
            frames, cam_d, proj_d, cfg, dec),
        "kernel": lambda: fs.launch_fused_scan(frames, params),
        "scan": lambda: model(frames),
    }
    times = {k: [] for k in runs}
    for name in ("plain", "kernel", "scan", "scan", "kernel", "plain"):
        times[name] += cuda_ms(runs[name])
    ms = {k: statistics.median(v) for k, v in times.items()}
    F = cfg.num_frames
    moved = (4 * F + 7 * 4) * CAM_H * CAM_W
    gbs = moved / (ms["kernel"] * 1e-3) / 1e9
    host = {f"{k}_host_ms": host_ms(fn) for k, fn in (
        ("scan_params", lambda: fs.scan_params(cam_d, proj_d, cfg, dec,
                                               (1.0, 1e4), 8, CAM_H, CAM_W)),
        ("launch", runs["kernel"]), ("scan", runs["scan"]))}
    emit("timing", card=card, runs_each=len(times["kernel"]),
         kernel_ms=ms["kernel"], plain_ms=ms["plain"], scan_ms=ms["scan"],
         **host,
         kernel_ms_spread=[min(times["kernel"]), max(times["kernel"])],
         plain_ms_spread=[min(times["plain"]), max(times["plain"])],
         scan_ms_spread=[min(times["scan"]), max(times["scan"])],
         kernel_bytes=moved, kernel_gb_s=gbs, hbm_peak_gb_s=HBM_PEAK_TBS * 1e3,
         hbm_share=gbs / (HBM_PEAK_TBS * 1e3),
         after=nvidia_smi("clocks.sm,power.draw,temperature.gpu"))

    print(json.dumps({"kernels": [{
        "name": "fused_decode_triangulate",
        "route": "cuda",
        "source": "slr_torch/kernels/csrc/fused_scan.cu",
        "replaces": "slr/kernels/fused_scan.py:80",
        "launches": launches,
        "max_abs_err": full["points_max_abs_err"],
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
