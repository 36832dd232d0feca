"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

From the repository root: builds the port's CUDA kernels with nvcc, one
process per source, all at once (K1 and K2 of
``slr_torch/kernels/csrc/fused_scan.cu``; K3, K4 and K5 of
``slr_torch/kernels/csrc/unwrap.cu``; K8 of
``slr_torch/kernels/csrc/band_nn.cu``; K6 and K7 of
``slr_torch/kernels/csrc/crossing.cu``), holds every kernel to its plain
PyTorch version on the card, and drives each scan path through the entry
point a user calls (``DenseReconstructor``, ``slr_torch.entry``) on the
config-3 rig (1280x1024 camera, 1024x768 projector): float32, uint8 and
uint16 ingest, Gray only, row+column midpoint with and without row phase,
multifreq, ``decode_only`` on a posed camera, the HDR exposure bracket (K2,
both fusions), and the spatial repair (``spatial_iters=4``: voting, K4 at
this size and K3 on a smaller camera; wavefront, K5). Then registration
(config 4): the sorted-band search K8 at 256k points, point-to-plane ICP on
its band route (``icp_point_to_plane``) at 256k and between two dense scans,
and ``register_scans`` on a 4-scan orbit, each registration twice and held
to the same bits. Then the two-camera merge (``reconstruct_two_camera``):
the crossing kernels K7 and K6 against their plain versions, bit for bit
(the reference's random case, a ragged one, the merge's passes and the 5 MP
calls; rows with long pair ranges, NaN and infinite codes, clipped bins,
unaligned rows, few and many rows, the widest row a block holds, and
channel layouts other than the merge's), the merge at full width in float32 and uint8 (K1 twice, K7 four times; RMS and
cells equal to the recorded digits), the tiled route on a 5 MP sensor (K6
four times), the splat and search oracles, and two merged rig poses
registered, twice (with the sample draw's ops repeated on the same
inputs). Each path's output is checked against the
synthetic ground truth and its launches counted; then the kernels, their
plain versions and the paths are timed with CUDA events (K6 and K7 also by
device time, from CUDA-graph replays, with their registers, blocks an SM
and K7's host launch time), and the whole run's wall time is printed.
Each phase prints one JSON line; the last line is ``{"ok": true, "device":
{...}}``. Any failed check ends the run with a traceback and a non-zero
exit, as does a machine without a CUDA device. Imports nothing of JAX."""

import json
import math
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
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
LIBRARIES = ("fused_scan", "unwrap", "band_nn", "crossing")   # csrc/<name>.cu, one nvcc each
WAVEFRONT_TOL = 1e-3       # rad, K5 against its plain version on reached pixels
BLOB_TOL = 1e-3            # rad, a repaired map against the clean phase
SPATIAL_ITERS = 4
# registration (config 4): the reference's dense band case
# (benchmarks/tpu_matrix.py:836-845, 876-897) and its config-4 orbit (:985-995)
N_BIG = 262144             # points per cloud
R_CORR = 8.0               # mm, the band case's correspondence radius
ICP_BAND_ITERS = 15
ICP_R_GATE, ICP_T_GATE = 1e-4, 1e-2   # max |R - R_true|, max |t - t_true| (mm)
K8_D2_RTOL = 1e-5          # K8 against its plain version (both compute sum((q - t)^2))
NEAR_TIE_MM2 = 1e-3        # two targets this close in d2 count as a tie
N_BRUTE = 4096             # queries per variant held to a float64 brute force
K8_BATCH = 10              # K8 launches per timed run, back to back
ORBIT_SCANS = 4
ROT_GATE_DEG, T_GATE_MM = 0.5, 2.0    # tests/test_pipeline.py:124-125
# a pair costs K8 8 fp32 instructions (3 sub, 3 mul, 2 add; no FMA); the
# card issues 33.5e12 a second, half its 67 TFLOP/s (an FMA counts 2)
FP32_ISSUE_PER_S = 33.5e12
# bounds: fp32 instructions of one voting sweep per pixel (4 neighbour
# votes of a subtraction, an IEEE division of ~8 instructions, a rint and a
# compare, then the consensus); K3 and K4 are bound by these, not by bytes
VOTE_INSTR_PER_PX_SWEEP = 50
# two-camera merge (slice 5): the reference's full-width case
# (benchmarks/tpu_matrix.py:453-478)
TWO_CAM_RMS_GATE_MM = 0.05
TWO_CAM_MIN_POINTS = 560_000
ORACLE_RMS_GATE_MM = 0.5              # tpu_matrix.py:511
TILED_W, TILED_H = 2448, 2048         # a 5 MP machine-vision sensor
CROSSING_REL_TOL = 1e-6               # where a bin has >= 2 crossings (sum order)
MERGE_MASK_AGREE = 0.9999             # kernel against plain route (tests/test_twocam.py:99-103)
MERGE_POINTS_TOL = 1e-3               # mm
INTERP = (True, True, False, False)   # invert_to_projector's channel layout
# the merge's outputs as recorded in PERF.md (RMS mm to 6 decimals, cells):
# a change to the crossing kernels must not move them
MERGE_RECORDED = {"float32": ("0.004995", 624712), "uint8": ("0.005320", 621927),
             "tiled_5mp": ("0.005374", 664270)}
GRAPH_LAUNCHES = 20        # launches a CUDA graph replays when a kernel's device time is taken
REGISTER_STAGES = ("_subsample", "icp_point_to_plane", "fpfh_features",
                   "ransac_align", "icp_projective", "pose_graph_optimize")


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


def graph_ms(fn, launches=GRAPH_LAUNCHES, replays=5):
    """Device time of one call of ``fn`` (kernel launches only): ``launches``
    calls captured in a CUDA graph, replayed back to back, CUDA events
    around each replay; no host time between launches."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return [t / launches for t in cuda_ms(graph.replay, replays, 1)]


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


def band_surface(n, device, seed=13):
    """The reference's scan-sized surface (benchmarks/tpu_matrix.py:836-845,
    876-882), from numpy seeded ``seed``: n targets on a bumpy sheet at
    z ~ 500 mm over [-250, 250]^2 mm, queries at the targets plus N(0, 1 mm)
    noise, and the sheet's unit normals. Returns (targets, queries,
    normals), (n, 3) each, on ``device``."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-250, 250, (n, 2))
    x, y = xy[:, 0], xy[:, 1]
    z = 500 + 20 * np.sin(x / 25.0) * np.cos(y / 30.0) + 8 * np.sin(y / 12.0)
    tgt = np.column_stack([xy, z]).astype(np.float32)
    qry = tgt + rng.normal(0, 1.0, (n, 3)).astype(np.float32)
    gx = 20 * np.cos(x / 25.0) / 25.0 * np.cos(y / 30.0)
    gy = -20 * np.sin(x / 25.0) * np.sin(y / 30.0) / 30.0 + 8 * np.cos(y / 12.0) / 12.0
    nrm = np.column_stack([-gx, -gy, np.ones_like(gx)])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in (tgt, qry, nrm)]


def pose_error(R, t, R_true, t_true):
    """(rotation error in degrees, translation error in mm), in float64;
    the angle from |R - R_true|_F = 2 sqrt(2) sin(angle / 2), which stays
    exact for small angles where acos of the trace does not."""
    dR = torch.linalg.norm(R.double() - R_true.double())
    ang = 2.0 * math.asin(min(float(dR) / (2.0 * math.sqrt(2.0)), 1.0))
    return math.degrees(ang), float(torch.linalg.norm(t.double() - t_true.double()))


def band_check(kb, nearest_neighbors, build_band_target, tgt, nrm, valid, qry, dup=None):
    """K8 on the sorted queries ``qry`` against the targets: bit-equal to its
    plain version; against the exact tiled search on every query (no miss
    within r, and where the two pick different targets, K8's is the nearer
    in float64); against a float64 brute force on ``N_BRUTE`` queries (the
    same target but for ties within ``NEAR_TIE_MM2``). The last
    ``len(dup)`` targets are copies of targets ``dup``: of a target and its
    copies, the one at the lowest sorted position wins. Returns (stats, band
    target, sorted queries, query mask)."""
    dev = qry.device
    if valid is None:
        valid = torch.ones(tgt.shape[0], dtype=torch.bool, device=dev)
    bt = build_band_target(tgt, nrm, valid)
    qc = qry[torch.sort(qry @ bt.axis, stable=True).indices].T.contiguous()
    Q = qc.shape[1]
    qv = torch.ones(Q, dtype=torch.bool, device=dev)
    d2, pts, nn_n, idx = kb.launch_band_nn(qc, qv, bt, R_CORR)
    p = kb.band_nn_sorted_reference(qc, qv, bt, R_CORR)
    torch.cuda.synchronize()
    hit = idx >= 0
    check(torch.equal(idx, p[3]), "K8: idx differs from the plain version")
    check(torch.equal(torch.isinf(d2), ~hit) and torch.equal(torch.isinf(p[0]), ~hit),
          "K8: hits and finite d2 disagree")
    d2_rel = float(((d2 - p[0]).abs() / p[0].clamp(min=1e-12))[hit].max())
    check(d2_rel <= K8_D2_RTOL, f"K8: d2 {d2_rel} relative from the plain version")
    check(torch.equal(pts, p[1]) and torch.equal(nn_n, p[2]),
          "K8: point or normal differs from the plain version")
    check(torch.equal(pts[hit], tgt[idx[hit]]) and torch.equal(nn_n[hit], nrm[idx[hit]])
          and bool(valid[idx[hit]].all()), "K8: the winner is not a valid target's")
    r2 = R_CORR * R_CORR
    q = qc.T

    def d64(i, rows=slice(None)):
        return ((q[rows].double() - tgt[i.clamp(min=0)].double()) ** 2).sum(dim=1)

    # every query, against the exact tiled search (expanded form, whose
    # rounding at |q| ~ 500 mm is some 0.02-0.06 mm^2)
    ie, _ = nearest_neighbors(q, tgt, valid)
    de, dk = d64(ie), d64(idx)
    within = de <= r2 - NEAR_TIE_MM2
    misses = int((within & ~hit).sum())
    check(misses == 0, f"K8: {misses} misses within r")
    check(bool((dk[hit] <= r2 + NEAR_TIE_MM2).all()), "K8: a hit beyond r")
    differ = hit & (idx != ie)
    check(bool((dk[differ] <= de[differ] * (1 + 1e-6)).all()),
          "K8 farther than the exact search where they differ")
    # a float64 brute force on N_BRUTE queries spread over the sorted order
    sel = torch.linspace(0, Q - 1, min(N_BRUTE, Q), device=dev).long()
    best, second, arg = [], [], []
    for rows in sel.split(256):
        d = ((q[rows, None, :].double() - tgt[None].double()) ** 2).sum(dim=-1)
        d = torch.where(valid[None], d, float("inf"))
        m, a = torch.min(d, dim=1)      # the first minimum: lowest index
        d.scatter_(1, a[:, None], float("inf"))
        best.append(m)
        arg.append(a)
        second.append(d.min(dim=1).values)
    best, second, arg = torch.cat(best), torch.cat(second), torch.cat(arg)
    clear = (second - best > NEAR_TIE_MM2) & (best <= r2 - NEAR_TIE_MM2)
    check(bool(hit[sel][best <= r2 - NEAR_TIE_MM2].all()), "K8: a brute-force miss")
    check(torch.equal(idx[sel][clear], arg[clear]), "K8: idx differs from brute force")
    check(bool((d64(idx[sel], sel)[hit[sel]] <= best[hit[sel]] * (1 + 1e-6)).all()),
          "K8: not the nearest by brute force")
    copies_won = 0
    if dup is not None:
        n_orig = tgt.shape[0] - dup.shape[0]
        pos = torch.empty_like(bt.index)            # sorted position of each target
        real = bt.index >= 0
        pos[bt.index[real]] = torch.arange(bt.index.shape[0], device=dev)[real]
        group = torch.cat([torch.arange(n_orig, device=dev), dup])
        first = pos[:n_orig].scatter_reduce(0, dup, pos[n_orig:], "amin")
        w = idx[hit]
        check(torch.equal(pos[w], first[group[w]]),
              "K8: a duplicate at a higher sorted position won")
        copies_won = int((w >= n_orig).sum())
    jstart, jend = kb.tile_bands(bt.axis @ qc, qv, bt, R_CORR)
    widths = (jend - jstart).clamp(min=0)
    return dict(queries=Q, targets=int(tgt.shape[0]), valid_targets=int(valid.sum()),
                hits=int(hit.sum()), misses_within_r=misses,
                d2_max_rel_err_vs_plain=d2_rel,
                d2_max_abs_err_vs_plain=float((d2 - p[0])[hit].abs().max()),
                idx_equal_plain=True,
                differ_from_exact=int(differ.sum()),
                exact_wrong_beyond_tie=int((differ & (de - dk > NEAR_TIE_MM2)).sum()),
                copies_won=copies_won,
                brute_force_queries=int(sel.numel()),
                brute_force_near_ties=int((~clear & (best <= r2)).sum()),
                band_tiles_mean=float(widths.float().mean()), band_tiles_max=int(widths.max()),
                target_tiles=int(bt.tlo.shape[0]),
                pairs=int(widths.sum()) * kb.tile_size(bt) * kb.QT), bt, qc, qv


def stage_times(module, names, fn):
    """Run ``fn`` once with each function ``module.<name>`` wrapped so that
    its wall time, from an idle card to its result on the card, adds to
    its total. Returns (result, {name: total ms}); restores the functions."""
    totals = dict.fromkeys(names, 0.0)
    originals = {n: getattr(module, n) for n in names}

    def timed(name, f):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            torch.cuda.synchronize()
            totals[name] += (time.perf_counter() - t0) * 1e3
            return out
        return run

    try:
        for n, f in originals.items():
            setattr(module, n, timed(n, f))
        out = fn()
    finally:
        for n, f in originals.items():
            setattr(module, n, f)
    return out, totals


def registration_phases(dev, cam, proj, cfg, counts_of, card):
    """Phases 19-23, config 4: K8 against its plain version, the exact
    search and a brute force at the reference's 256k size; the 15-iteration
    band ICP (15 K8 launches); ICP between two dense config-3 scans of the
    rocks scene (through K1, then K8); ``register_scans`` on a 4-scan orbit;
    then their times. Returns K8's entry of the ``kernels`` line."""
    from slr_torch.config import RegistrationConfig
    from slr_torch.geom.se3 import so3_exp
    from slr_torch.kernels import band_nn as kb
    from slr_torch.pipeline import registerfuse as rf
    from slr_torch.pipeline.reconstruct import DenseReconstructor
    from slr_torch.registration.band import build_band_target
    from slr_torch.registration.icp import _resolve_nn_method, icp_point_to_plane
    from slr_torch.registration.nn import nearest_neighbors
    from slr_torch.synth.render import move_rig, quantize_frames, render_scan
    from slr_torch.synth.scene import rocks_scene

    def quiet(n, *allowed):
        return all(v == 0 for k, v in n.items() if k not in allowed)

    # phase 19: K8 at 256k: the reference's case; a ragged query count with
    # 10 % of the targets masked; 1/8 of the targets duplicated
    tgt, qry, nrm = band_surface(N_BIG, dev)
    rng = np.random.default_rng(14)
    dup = torch.from_numpy(rng.integers(0, N_BIG, N_BIG // 8)).to(dev)
    masked = torch.from_numpy(rng.random(N_BIG) > 0.1).to(dev)
    variants = {"256k": (tgt, nrm, None, qry, None),
                "ragged_masked": (tgt, nrm, masked, qry[:N_BIG - 37], None),
                "duplicates": (torch.cat([tgt, tgt[dup]]), torch.cat([nrm, nrm[dup]]),
                               None, qry, dup)}
    k8 = {}
    for name, (t, n, v, q, d) in variants.items():
        k8[name], bt_v, qc_v, qv_v = band_check(kb, nearest_neighbors, build_band_target,
                                                t, n, v, q, d)
        if name == "256k":
            bt, qc, qv = bt_v, qc_v, qv_v
    emit("k8_band_nn", r_mm=R_CORR, tile=kb.QT, **k8)

    # phase 20: the reference's ICP case on the band route: "auto" resolves
    # to band on the card, one K8 launch per iteration
    R_true = so3_exp(torch.tensor([0.004, -0.006, 0.005], device=dev))
    t_true = torch.tensor([1.5, -1.0, 2.0], device=dev)
    tgt_icp = tgt @ R_true.T + t_true
    n_icp = nrm @ R_true.T
    check(_resolve_nn_method("auto", N_BIG, N_BIG) == "band", "auto is not band at 256k")

    def band_icp():
        return icp_point_to_plane(tgt, tgt_icp, n_icp, iters=ICP_BAND_ITERS,
                                  max_corr_dist=R_CORR)

    res, n = counts_of(band_icp)
    check(n["k8"] == ICP_BAND_ITERS and quiet(n, "k8"), f"icp_band_256k: launches {n}")
    launches = n["k8"]
    r_err = float((res.R - R_true).abs().max())
    t_err = float((res.t - t_true).abs().max())
    check(r_err <= ICP_R_GATE and t_err <= ICP_T_GATE,
          f"icp_band_256k: R_err {r_err}, t_err {t_err} mm")
    emit("icp_band_256k", iters=ICP_BAND_ITERS, launches=n["k8"], R_err=r_err,
         t_err_mm=t_err, R_gate=ICP_R_GATE, t_gate_mm=ICP_T_GATE,
         rms_mm=float(res.rms), inlier_frac=float(res.inlier_frac))

    # the config-4 orbit: ORBIT_SCANS uint8 scans of the rocks scene from a
    # moving config-3 rig, decoded by K1 with the rig's own calibration, so
    # registration has to recover each rig pose
    cam_d, proj_d = cam.to(dev), proj.to(dev)
    poses, stacks = [], []
    for s in range(ORBIT_SCANS):
        R_m = so3_exp(torch.tensor([0.0, 0.025 * s, 0.008 * s], device=dev))
        t_m = torch.tensor([7.0 * s, -3.0 * s, 0.0], device=dev)
        cam_s, proj_s = move_rig(cam_d, proj_d, R_m, t_m)
        sc = render_scan(cam_s, proj_s, rocks_scene(cam_s, CAM_H, CAM_W), cfg,
                         noise_std=0.003,
                         generator=torch.Generator(device=dev).manual_seed(40 + s))
        stacks.append(quantize_frames(sc.frames))
        poses.append((R_m, t_m))
    model = DenseReconstructor(cam, proj, cfg).to(dev)

    def decode():
        return [model(f) for f in stacks]

    clouds, n = counts_of(decode)
    check(n["k1"] == ORBIT_SCANS and quiet(n, "k1"), f"orbit decode: launches {n}")
    check(all(c.mask.float().mean() > 0.3 for c in clouds), "orbit coverage")

    # phase 21: ICP between two dense scans: 262144 samples of each, so
    # "auto" takes the band route, K8 once per iteration
    rc = RegistrationConfig()
    src, _ = rf._subsample(clouds[1], N_BIG, seed=1)
    tgt_d, tgt_n = rf._subsample(clouds[0], N_BIG, seed=0)
    check(torch.equal(src, rf._subsample(clouds[1], N_BIG, seed=1)[0]),
          "_subsample: two draws from one seed differ")

    def dense_icp():
        return icp_point_to_plane(src, tgt_d, tgt_n, iters=rc.icp_iters,
                                  max_corr_dist=rc.icp_max_corr_dist)

    res, n = counts_of(dense_icp)
    check(n["k8"] == rc.icp_iters and quiet(n, "k8"), f"icp_dense_scans: launches {n}")
    launches += n["k8"]
    rot, tr = pose_error(res.R, res.t, *poses[1])
    check(rot < ROT_GATE_DEG and tr < T_GATE_MM,
          f"icp_dense_scans: {rot} deg, {tr} mm")
    again = dense_icp()
    same_dense = torch.equal(res.R, again.R) and torch.equal(res.t, again.t)
    check(same_dense, "icp_dense_scans: two calls give other poses")
    emit("icp_dense_scans", samples=N_BIG, iters=rc.icp_iters,
         max_corr_dist_mm=rc.icp_max_corr_dist, launches=n["k8"], rot_err_deg=rot,
         t_err_mm=tr, rot_gate_deg=ROT_GATE_DEG, t_gate_mm=T_GATE_MM,
         rms_mm=float(res.rms), inlier_frac=float(res.inlier_frac),
         valid_px=[int(c.mask.sum()) for c in clouds[:2]], bit_identical_calls=same_dense)

    # phase 22: register_scans on the orbit with the defaults (4096
    # samples: the exact route, no K8), features, the projective polish and
    # loop closures; then once more with each stage timed
    def register(cl):
        return rf.register_scans(cl, rc, use_features=True, cam=cam_d, loop_closures=True)

    reg, n = counts_of(lambda: register(clouds))
    check(quiet(n), f"config4_register: launches {n}")
    errs = [pose_error(reg.R[s], reg.t[s], *poses[s]) for s in range(ORBIT_SCANS)]
    max_rot, max_t = max(e[0] for e in errs), max(e[1] for e in errs)
    check(max_rot < ROT_GATE_DEG and max_t < T_GATE_MM,
          f"config4_register: {max_rot} deg, {max_t} mm")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    reg2, stages = stage_times(rf, REGISTER_STAGES, lambda: register(clouds))
    same_reg = torch.equal(reg.R, reg2.R) and torch.equal(reg.t, reg2.t)
    check(same_reg, "config4_register: two calls give other poses")
    emit("config4_register", scans=ORBIT_SCANS, samples=rc.icp_sample_points,
         bit_identical_calls=same_reg,
         rot_err_deg=[e[0] for e in errs], t_err_mm=[e[1] for e in errs],
         max_rot_err_deg=max_rot, max_t_err_mm=max_t, rot_gate_deg=ROT_GATE_DEG,
         t_gate_mm=T_GATE_MM, icp_rms_mm=reg.icp_rms.tolist(), pg_rms=float(reg.pg_rms),
         stage_ms={"decode": decode_ms, **{k.strip("_"): v for k, v in stages.items()}},
         stage_timing="host wall, a card sync around every call")

    # phase 23: times, in turns: K8 (K8_BATCH launches a timed run), its
    # plain version and the exact search at 256k (CUDA events); the band
    # ICP; ICP between the dense scans; and config 4 end to end (decode +
    # register_scans, host-bound)
    def k8_batch():
        for _ in range(K8_BATCH):
            kb.launch_band_nn(qc, qv, bt, R_CORR)

    runs = {"plain_k8": (lambda: kb.band_nn_sorted_reference(qc, qv, bt, R_CORR), 5, 1),
            "k8": (k8_batch, TIMED_RUNS, 3),
            "exact_nn": (lambda: nearest_neighbors(qc.T, tgt), 3, 1),
            "icp_band_256k": (band_icp, 5, 1),
            "icp_dense_scans": (dense_icp, 5, 1),
            "config4_e2e": (lambda: register(decode()), 3, 1)}
    turns = [("plain_k8", "k8", "exact_nn", "exact_nn", "k8", "plain_k8"),
             ("icp_band_256k", "icp_dense_scans", "icp_dense_scans", "icp_band_256k"),
             ("config4_e2e", "config4_e2e")]
    times = {k: [] for k in runs}
    for turn in turns:
        for name in turn:
            fn, n_runs, warmup = runs[name]
            times[name] += cuda_ms(fn, n_runs, warmup)
    times["k8"] = [t / K8_BATCH for t in times["k8"]]
    ms = {k: statistics.median(v) for k, v in times.items()}
    pairs = k8["256k"]["pairs"]
    emit("timing_registration", card=card, **{f"{k}_ms": v for k, v in ms.items()},
         **{f"{k}_ms_spread": [min(v), max(v)] for k, v in times.items()},
         runs_each={k: len(v) for k, v in times.items()}, k8_pairs=pairs,
         k8_pairs_per_s=pairs / (ms["k8"] * 1e-3),
         k8_fp32_issue_share=pairs * 8 / FP32_ISSUE_PER_S / (ms["k8"] * 1e-3),
         exact_pairs_per_s=N_BIG * N_BIG / (ms["exact_nn"] * 1e-3),
         after=nvidia_smi("clocks.sm,power.draw,temperature.gpu"))
    return {"name": "band_nn_sorted", "route": "cuda",
            "source": "slr_torch/kernels/csrc/band_nn.cu",
            "replaces": "slr/registration/band.py:121",
            "launches": launches,
            "max_abs_err": max(v["d2_max_abs_err_vs_plain"] for v in k8.values()),
            "max_abs_err_of": "d2 (mm^2) against the plain version; points, normals "
                              "and idx equal",
            "ms": ms["k8"], "plain_ms": ms["plain_k8"], "exact_nn_ms": ms["exact_nn"],
            # 8 fp32 instructions a pair (3 sub, 3 mul, 2 add; no FMA)
            "bound_ms": pairs * 8 / FP32_ISSUE_PER_S * 1e3, "bound_by": "operations",
            "library_ms": None}


def crossing_agree(name, got, plain):
    """(cnt, vals) of K6 or K7 against their plain version: counts equal;
    bit-equal where a bin has at most one crossing (every other term is an
    exact zero); relative CROSSING_REL_TOL of max(|v|, 1) where it has
    more; and bit-equal everywhere (the plain versions sum each bin in the
    kernels' ascending pair order)."""
    (cnt, vals), (cnt_p, vals_p) = got, plain
    check(torch.equal(cnt, cnt_p), f"{name}: crossing counts differ")
    one = (cnt_p <= 1)[None].expand_as(vals_p)
    check(torch.equal(vals[one], vals_p[one]), f"{name}: not bit-equal where cnt <= 1")
    rel = ((vals - vals_p).abs() / vals_p.abs().clamp(min=1.0))[~one]
    rel = float(rel.max()) if rel.numel() else 0.0
    check(rel <= CROSSING_REL_TOL, f"{name}: relative {rel} where cnt >= 2")
    same = bool(torch.equal(vals, vals_p))
    check(same, f"{name}: not bit-equal to its plain version")
    return dict(shape=list(vals.shape), crossings=int(cnt_p.sum()),
                max_cnt=float(cnt_p.max()), bins_cnt_ge2=int((cnt_p >= 2).sum()),
                bit_equal=same, max_rel_err_cnt_ge2=rel,
                max_abs_err=float((vals - vals_p).abs().max()))


def crossing_case(dev, R, U, seed, wiggle=0.0, start=(-3, 3), nan_inf=False):
    """The reference's random crossing case (tests/test_twocam.py:316-322),
    from numpy seeded ``seed``; ``wiggle``: noise on the codes, so that
    bins cross several times; ``start``: the range of a row's first code
    (below 0: bins clipped at the low end); ``nan_inf``: 3 % of the codes
    NaN, 1 % +inf, 1 % -inf."""
    rng = np.random.default_rng(seed)
    code = np.cumsum(rng.uniform(0.2, 1.4, (R, U)), axis=1)
    code = code - code[:, :1] + rng.uniform(*start, (R, 1))
    code = (code + wiggle * rng.normal(size=(R, U))).astype(np.float32)
    if nan_inf:
        for value, share in ((np.nan, 0.03), (np.inf, 0.01), (-np.inf, 0.01)):
            code[rng.random((R, U)) < share] = value
    valid = rng.random((R, U)) > 0.05
    ch = (rng.normal(0, 1, (4, R, U)) * 10 + 50).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (code, valid, ch)]


def span_case(dev, seed=17):
    """K6's pairs spanning 30-45 bins (K = 150), clipped at both ends, with
    NaN and infinite codes and 10 % dead pairs: (lo, hi, payload, K)."""
    rng = np.random.default_rng(seed)
    R, U, N, K = 64, 333, 7, 150
    lo = rng.uniform(-20, K + 5, (R, U)).astype(np.float32)
    hi = (lo + rng.uniform(30, 45, (R, U))).astype(np.float32)
    dead = rng.random((R, U)) < 0.1
    lo[dead] = hi[dead] = -1.0
    lo[0, :7] = [np.nan, -np.inf, 3.5, np.nan, -np.inf, 10.0, np.inf]
    hi[0, :7] = [5.0, 2.5, np.nan, np.nan, np.inf, np.inf, np.inf]
    pay = rng.normal(0, 3, (R, N, U)).astype(np.float32)
    pay[np.broadcast_to(dead[:, None, :], pay.shape)] = 0.0
    return [torch.from_numpy(a).to(dev) for a in (lo, hi, pay)] + [K]


def distinct_results(fn, repeats=8):
    """The number of different results (by their bits) of ``repeats`` calls
    of ``fn``."""
    seen = []
    for _ in range(repeats):
        out = fn()
        if not any(torch.equal(out, o) for o in seen):
            seen.append(out)
    return len(seen)


def draw_repeats(cloud):
    """Each op behind the registration's sample draw, eight times on the
    same inputs: ``register_scans``' subsample weights over ``cloud``'s
    pixels through ``torch.multinomial`` and ``torch.cumsum`` (float scans)
    and through the port's fixed-point draw, and the 6x6 normal equations
    of N_BIG rows (cuBLAS). Returns {op: distinct results of 8}."""
    from slr_torch.pipeline import registerfuse as rf
    from slr_torch.registration.normals import grid_normals

    normals = grid_normals(cloud.points, cloud.mask)
    vdir = cloud.points / (torch.linalg.norm(cloud.points, dim=-1, keepdim=True) + 1e-9)
    p = (cloud.mask & (torch.abs(torch.sum(normals * vdir, dim=-1)) > 0.35)).reshape(-1)
    p = p.to(torch.float32) / torch.sum(p)

    def gen(seed):
        return torch.Generator(device=p.device).manual_seed(seed)

    w = torch.rand(N_BIG, generator=gen(5), device=p.device)
    A = torch.randn((N_BIG, 6), generator=gen(6), device=p.device)
    ops = {"torch_multinomial_4096": lambda: torch.multinomial(p, 4096, replacement=True,
                                                               generator=gen(0)),
           "port_draw_4096": lambda: rf._draw_samples(p, 4096, 0),
           "torch_cumsum": lambda: torch.cumsum(p, 0),
           f"normal_equations_{N_BIG}": lambda: (A * w[:, None]).T @ A}
    return {"pixels": p.numel(), **{k: distinct_results(fn) for k, fn in ops.items()}}


def captured(module, name, run):
    """Run ``run`` with ``module.<name>`` wrapped to record each call's
    arguments; returns (result, [(args, kwargs), ...])."""
    orig, calls = getattr(module, name), []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    setattr(module, name, record)
    try:
        out = run()
    finally:
        setattr(module, name, orig)
    return out, calls


def crossing_k7_bytes(R, U, K, C=4):
    """K7's traffic with every input read once: code (4 B), valid (1 B) and
    C channels (4 B) per pixel; cnt and C values (4 B) per bin written."""
    return R * U * (5 + 4 * C) + R * K * 4 * (1 + C)


def _pixels_of(pairs):
    """The pixels (R, U) of a set of pairs (R, U - 1): both ends of each."""
    px = torch.zeros((pairs.shape[0], pairs.shape[1] + 1), dtype=torch.bool,
                     device=pairs.device)
    px[:, :-1] |= pairs
    px[:, 1:] |= pairs
    return int(px.sum())


def fires_a_bin(lo, hi, K):
    """(R, U) bool: the pairs that cross at least one bin k in [0, K)."""
    k0 = torch.clamp(torch.ceil(lo), min=0.0)
    k1 = torch.clamp(torch.ceil(hi), max=float(K))
    return (lo < hi) & (k0 < k1)


def crossing_k7_bytes_needed(kx, code, valid, ch, K, gates, dmin, dmax):
    """K7's least traffic on this run's data: code and valid of every pixel;
    the gate channels at the pixels of the pairs that pass the validity and
    step tests; every other channel only at the pixels of the pairs that
    cross a bin; cnt and C values per bin written once."""
    R, U = code.shape
    C = ch.shape[0]
    cl, chh = code[:, :-1], code[:, 1:]
    d = chh - cl
    cand = valid[:, :-1] & valid[:, 1:] & (d > dmin) & (d < dmax)
    gate = kx.gate_mask(ch, gates)
    fire = (cand if gate is None else cand & gate) & fires_a_bin(cl, chh, K)
    n_gate = len({c for c, _ in gates})
    return (R * U * 5 + n_gate * 4 * _pixels_of(cand) + (C - n_gate) * 4 * _pixels_of(fire)
            + R * K * 4 * (1 + C))


def crossing_k6_bytes(R, U, N, K):
    """K6's traffic with every input read once: lo, hi and N payload
    channels per pair; N sums per bin written."""
    return (2 + N) * 4 * R * U + N * 4 * R * K


def crossing_k6_bytes_needed(lo, hi, N, K):
    """K6's least traffic on this run's data: lo and hi of every pair, the
    N payload values of the pairs that cross a bin (no other pair's payload
    enters a sum), N sums per bin written once."""
    R, U = lo.shape
    return 8 * R * U + N * 4 * int(fires_a_bin(lo, hi, K).sum()) + N * 4 * R * K


def two_camera_phases(dev, counts_of, card, ptxas):
    """Phases 24-30, the two-camera merge (slice 5): K7 and K6 against
    their plain versions; ``reconstruct_two_camera`` at the reference's
    full width in float32 and uint8; the tiled route on a 5 MP sensor; the
    splat and search oracles; two merged rig poses registered; then times.
    Returns the ``kernels`` entries of K7 and K6."""
    from slr_torch.config import (
        DecodeConfig, PatternConfig, ReconstructConfig, RegistrationConfig)
    from slr_torch.geom.camera import pixel_to_ray
    from slr_torch.geom.se3 import so3_exp
    from slr_torch.kernels import crossing as kx
    from slr_torch.pipeline import registerfuse as rf
    from slr_torch.pipeline import twocam
    from slr_torch.synth.render import move_rig, quantize_frames, render_scan, two_camera_rig
    from slr_torch.synth.scene import rocks_scene, spheres_scene

    cfg = PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=7,
                        row_gray_bits=6, phase_steps=4, row_phase_steps=4)
    dec = DecodeConfig()
    rec = ReconstructConfig(min_depth=300.0, max_depth=900.0)

    def render_pair(W, H, scene, seed, pose=None, uint8=False):
        """Both cameras' stacks (36 frames each) of ``scene`` from the rig
        moved by ``pose``; noise 0.003, cast shadows."""
        c1, c2, proj = two_camera_rig(W, H, PROJ_W, PROJ_H, device=dev)
        scans = []
        for i, c in enumerate((c1, c2)):
            if pose is not None:
                c, p = move_rig(c, proj, *pose)
            else:
                p = proj
            sc = render_scan(c, p, scene(c, H, W), cfg, noise_std=0.003, cast_shadows=True,
                             generator=torch.Generator(device=dev).manual_seed(seed + i))
            if uint8:
                sc = sc._replace(frames=quantize_frames(sc.frames))
            scans.append(sc)
        return (c1, c2, proj), scans

    def merge(f1, f2, c1, c2, **kw):
        return twocam.reconstruct_two_camera(f1, f2, c1, c2, cfg, dec, rec, **kw)

    def proj_truth(proj, scene):
        """Ground truth on the projector grid (tpu_matrix.py:469-478): the
        first surface along each projector ray."""
        u, v = torch.meshgrid(torch.arange(PROJ_W, dtype=torch.float32, device=dev),
                              torch.arange(PROJ_H, dtype=torch.float32, device=dev),
                              indexing="xy")
        o, d = pixel_to_ray(proj, u, v)
        dz = torch.einsum("j,...j->...", proj.R[2], d)
        return o + (scene(proj, PROJ_H, PROJ_W) / dz)[..., None] * d

    def rms_grid(cloud, truth):
        err = torch.linalg.norm(cloud.points - truth, dim=-1)[cloud.mask]
        return math.sqrt(float((err * err).mean())), int(cloud.mask.sum())

    def merge_launches(n, k1, k7, k6):
        check((n["k1"], n["k7"], n["k6"]) == (k1, k7, k6)
              and all(v == 0 for k, v in n.items() if k not in ("k1", "k6", "k7")),
              f"merge launches {n}")

    # the config-3-width rig (1280x1024 cameras, 1024x768 projector),
    # spheres_scene, float32
    (c1, c2, proj), scans = render_pair(CAM_W, CAM_H, spheres_scene, 20)
    f1, f2 = (s.frames for s in scans)
    truth = proj_truth(proj, spheres_scene)

    # phase 24: K7 against its plain version: the reference's random case, a
    # ragged noisy one, and the four passes of the full-width merge
    _, k7_calls = captured(twocam, "crossing_interp_fused", lambda: merge(f1, f2, c1, c2))
    check(len(k7_calls) == 4, f"{len(k7_calls)} fused crossing passes in a merge")
    cases = {"random_24x700": (*crossing_case(dev, 24, 700, 3), 520, INTERP, ((1, 3.0),),
                               0.125, 4.0),
             "ragged_37x333": (*crossing_case(dev, 37, 333, 370, wiggle=0.5), 200, INTERP,
                               ((1, 25.0),), 0.125, 4.0)}
    for i, (a, kw) in enumerate(k7_calls):
        cases[f"merge_cam{i // 2 + 1}_pass{i % 2 + 1}"] = (
            *a[:5], kw["gates"], kw["dmin"], kw["dmax"])
    # the redesign's cases: long pair ranges (bins crossed many times), NaN
    # and infinite codes, bins clipped at both ends, rows not a multiple of
    # 16 bytes (ragged heads and tails staged by threads), R below the SM
    # count and far above the persistent grid, and the widest row a block
    # holds (one row buffer, no prefetch); then layouts other than the
    # merge's, which take K7's general build
    lib = kx.library()
    u_limit = 2048
    while lib.slr_interp_fused_smem(u_limit + 1, 4, u_limit + 1) <= kx.SMEM_MAX:
        u_limit += 1
    gate25 = ((1, 25.0),)
    cases.update({
        "wiggle2_12x333": (*crossing_case(dev, 12, 333, 11, wiggle=2.0), 260, INTERP, gate25,
                           0.125, 4.0),
        "nan_inf_9x701": (*crossing_case(dev, 9, 701, 12, nan_inf=True), 520, INTERP, gate25,
                          0.125, 4.0),
        "clipped_10x300": (*crossing_case(dev, 10, 300, 13, wiggle=0.3, start=(-30, -5)),
                           120, INTERP, gate25, 0.125, 4.0),
        "rows_below_sms_7x1280": (*crossing_case(dev, 7, 1280, 14, wiggle=0.3), 1024, INTERP,
                                  gate25, 0.125, 4.0),
        "rows_above_grid_3000x130": (*crossing_case(dev, 3000, 130, 15, wiggle=0.3), 110,
                                     INTERP, gate25, 0.125, 4.0),
        f"smem_limit_3x{u_limit}": (*crossing_case(dev, 3, u_limit, 16, wiggle=0.3), u_limit,
                                    INTERP, gate25, 0.125, 4.0),
    })
    for name, (R, U, K, seed, c, interp, gates) in {
            "layout_c3_interp_101_40x517": (40, 517, 400, 18, 3, (True, False, True),
                                            ((2, 25.0),)),
            "layout_c4_interp_0110_20x701": (20, 701, 520, 19, 4, (False, True, True, False),
                                             ((0, 30.0), (3, 30.0))),
            "layout_c1_nearest_9x333": (9, 333, 260, 20, 1, (False,), ())}.items():
        code, valid, ch = crossing_case(dev, R, U, seed, wiggle=0.5)
        cases[name] = (code, valid, ch[:c].contiguous(), K, interp, gates, 0.125, 4.0)
    k7_checks, k6_checks, k7_err, k6_err = {}, {}, 0.0, 0.0
    for name, (code, valid, ch, K, interp, gates, dmin, dmax) in cases.items():
        got = kx.crossing_interp_fused(code, valid, ch, K, interp, gates, dmin, dmax)
        plain = kx.crossing_interp_fused_reference(code, valid, ch, K, interp, gates, dmin,
                                                   dmax)
        torch.cuda.synchronize()
        k7_checks[name] = crossing_agree(f"K7 {name}", got, plain)
        k7_checks[name]["grid_blocks_per_sm"] = list(kx.launch_shape(
            "K7", *code.shape, ch.shape[0], K, interp))
        k7_err = max(k7_err, k7_checks[name]["max_abs_err"])
        # phase 25 on the same cases: K6 through crossing_interp
        gate = kx.gate_mask(ch, gates)
        got6 = kx.crossing_interp(code, valid, ch, K, interp, dmin, dmax, pair_gate=gate)
        plain6 = kx.crossing_interp(code, valid, ch, K, interp, dmin, dmax,
                                    use_kernel=False, pair_gate=gate)
        torch.cuda.synchronize()
        k6_checks[name] = crossing_agree(f"K6 {name}", got6, plain6)
        k6_checks[name]["vs_k7"] = crossing_agree(f"K6 vs K7 {name}", got6, got)
        k6_err = max(k6_err, k6_checks[name]["max_abs_err"])
    # K6 alone: pairs spanning 30-45 bins, and the widest row a block holds
    # (one row buffer, no prefetch)
    u6_limit = 2048
    while lib.slr_bin_sum_smem(u6_limit + 1, 1024) <= kx.SMEM_MAX:
        u6_limit += 1
    lo_w, hi_w, pay_w, _ = kx.crossing_pairs(
        *crossing_case(dev, 5, u6_limit + 1, 21, wiggle=0.3)[:3], INTERP)
    for name, (lo_s, hi_s, pay_s, K_s) in {
            "spans_30_45_bins": span_case(dev),
            f"smem_limit_5x{u6_limit}": (lo_w, hi_w, pay_w, 1024)}.items():
        ref_s = kx.crossing_bin_sum_reference(lo_s, hi_s, pay_s, K_s)
        fires = kx.crossing_bin_sum_reference(lo_s, hi_s, torch.ones_like(pay_s[:, :1]), K_s)
        out_s = kx.launch_bin_sum(lo_s, hi_s, pay_s, K_s)
        torch.cuda.synchronize()
        same = bool(torch.equal(out_s, ref_s))
        check(same, f"K6 {name}: not bit-equal to its plain version")
        k6_checks[name] = dict(
            shape=list(out_s.shape), max_fires=float(fires.max()), bit_equal=same,
            max_abs_err=float((out_s - ref_s).abs().max()),
            grid_blocks_per_sm=list(kx.launch_shape("K6", *lo_s.shape, pay_s.shape[1], K_s)))
    emit("k7_vs_plain", rel_tol=CROSSING_REL_TOL, **k7_checks)

    # phase 26: the merge at full width, float32 and uint8: K1 (decode_only)
    # twice, K7 four times; the card's plain route; two calls bit-identical
    merge_runs, k7_launches = {}, 0
    frames = {"float32": (f1, f2), "uint8": tuple(quantize_frames(f) for f in (f1, f2))}
    for kind, (g1, g2) in frames.items():
        cloud, n = counts_of(lambda: merge(g1, g2, c1, c2))
        merge_launches(n, 2, 4, 0)
        k7_launches += n["k7"]
        check(tuple(cloud.points.shape) == (PROJ_H, PROJ_W, 3)
              and bool(torch.isfinite(cloud.points).all()), f"merge {kind} points")
        rms, n_pts = rms_grid(cloud, truth)
        check(rms <= TWO_CAM_RMS_GATE_MM and n_pts >= TWO_CAM_MIN_POINTS,
              f"merge {kind}: RMS {rms} mm over {n_pts} points")
        check((f"{rms:.6f}", n_pts) == MERGE_RECORDED[kind],
              f"merge {kind}: {rms:.6f} mm over {n_pts} cells, recorded {MERGE_RECORDED[kind]}")
        again = merge(g1, g2, c1, c2)
        same = all(torch.equal(a, b) for a, b in zip(cloud, again))
        check(same, f"merge {kind}: two calls differ")
        plain = merge(g1, g2, c1, c2, merge_kernel=False)
        torch.cuda.synchronize()
        agree = float((plain.mask == cloud.mask).float().mean())
        both = plain.mask & cloud.mask
        dmax = float(torch.linalg.norm(plain.points - cloud.points, dim=-1)[both].max())
        check(agree >= MERGE_MASK_AGREE and dmax <= MERGE_POINTS_TOL,
              f"merge {kind} against the plain route: {agree}, {dmax} mm")
        merge_runs[kind] = dict(launches=n, rms_mm=rms, valid_points=n_pts,
                                plain_route_mask_agree=agree, plain_route_max_dpoints_mm=dmax,
                                bit_identical_calls=same)
    emit("two_camera_merge", rms_gate_mm=TWO_CAM_RMS_GATE_MM,
         min_points=TWO_CAM_MIN_POINTS, pattern_frames=cfg.num_frames, **merge_runs)

    # phase 27: the tiled route on a 5 MP sensor: 1024 x 2448 x 4 B = 10 MB
    # passes the reference's 8 MiB rule, so every pass takes K6; rendered in
    # float32 and quantized, one camera at a time
    check(not twocam.takes_fused(TILED_H, TILED_W, PROJ_W, PROJ_H), "5 MP takes K7")
    (t1, t2, tproj), tscans = render_pair(TILED_W, TILED_H, spheres_scene, 30, uint8=True)
    tf1, tf2 = (s.frames for s in tscans)
    del tscans
    torch.cuda.empty_cache()
    (tcloud, n), k6_calls = captured(
        twocam, "crossing_interp", lambda: counts_of(lambda: merge(tf1, tf2, t1, t2)))
    merge_launches(n, 2, 0, 4)
    k6_launches = n["k6"]
    trms, tn = rms_grid(tcloud, proj_truth(tproj, spheres_scene))
    check(trms <= TWO_CAM_RMS_GATE_MM, f"tiled merge RMS {trms} mm")
    check((f"{trms:.6f}", tn) == MERGE_RECORDED["tiled_5mp"],
          f"tiled merge: {trms:.6f} mm over {tn} cells, "
          f"recorded {MERGE_RECORDED['tiled_5mp']}")
    k6_5mp = {}
    for i, (a, kw) in enumerate(k6_calls):
        code, valid, ch, K = a[:4]
        got6 = kx.crossing_interp(*a, **kw)
        plain6 = kx.crossing_interp(*a, **{**kw, "use_kernel": False})
        torch.cuda.synchronize()
        key = f"cam{i // 2 + 1}_pass{i % 2 + 1}"
        k6_5mp[key] = crossing_agree(f"K6 5 MP call {i}", got6, plain6)
        interp = a[4]    # payload: the count, (a, g) per interpolated channel, one term else
        k6_5mp[key]["grid_blocks_per_sm"] = list(kx.launch_shape(
            "K6", code.shape[0], code.shape[1] - 1, 1 + len(interp) + sum(interp), K))
        k6_err = max(k6_err, k6_5mp[key]["max_abs_err"])
    emit("k6_vs_plain", rel_tol=CROSSING_REL_TOL, **k6_checks, **{f"5mp_{k}": v for k, v in
                                                                 k6_5mp.items()})
    emit("two_camera_tiled", sensor=[TILED_W, TILED_H], dtype=str(tf1.dtype), launches=n,
         rms_mm=trms, valid_points=tn, rms_gate_mm=TWO_CAM_RMS_GATE_MM)

    # phase 28: the oracles on the 1280x1024 float32 scan, on the cam-1 grid
    oracles = {}
    clouds_o = {}
    for method in ("splat", "search"):
        cl, n = counts_of(lambda: merge(f1, f2, c1, c2, method=method))
        merge_launches(n, 2, 0, 0)
        rms, n_pts = rms_vs_truth(cl.points, cl.mask, scans[0])
        check(rms < ORACLE_RMS_GATE_MM, f"{method}: RMS {rms} mm")
        oracles[method] = dict(rms_mm=rms, valid_points=n_pts)
        clouds_o[method] = cl
    both = clouds_o["search"].mask & clouds_o["splat"].mask
    d = torch.linalg.norm(clouds_o["search"].points - clouds_o["splat"].points, dim=-1)[both]
    share = int(both.sum()) / max(int(clouds_o["splat"].mask.sum()), 1)
    p95 = float(torch.quantile(d, 0.95))
    check(share >= 0.85 and p95 < 0.5, f"search vs splat: {share}, p95 {p95} mm")
    emit("two_camera_oracles", rms_gate_mm=ORACLE_RMS_GATE_MM, both_valid_of_splat=share,
         p95_dpoints_mm=p95, **oracles)

    # phase 29: two rig poses of rocks_scene, merged, then registered
    # (tests/test_twocam.py:208-246)
    R_m = so3_exp(torch.tensor([0.0, 0.04, 0.01], device=dev))
    t_m = torch.tensor([10.0, -5.0, 3.0], device=dev)
    eye = (torch.eye(3, device=dev), torch.zeros(3, device=dev))
    rclouds = []
    for i, pose in enumerate((eye, (R_m, t_m))):
        _, rs = render_pair(CAM_W, CAM_H, rocks_scene, 50 + 10 * i, pose=pose)
        cl, n = counts_of(lambda: merge(rs[0].frames, rs[1].frames, c1, c2))
        merge_launches(n, 2, 4, 0)
        k7_launches += n["k7"]
        rclouds.append(cl)
    def register_two():
        return rf.register_scans(rclouds, RegistrationConfig(icp_sample_points=2048),
                                 use_features=False, loop_closures=False)

    reg, n = counts_of(register_two)
    rot, tr = pose_error(reg.R[1], reg.t[1], R_m, t_m)
    check(rot < ROT_GATE_DEG and tr < T_GATE_MM, f"two-camera registration: {rot} deg, {tr} mm")
    reg2 = register_two()
    same = torch.equal(reg.R, reg2.R) and torch.equal(reg.t, reg2.t)
    check(same, "two-camera registration: two calls give other poses")
    repeats = draw_repeats(rclouds[0])
    check(repeats["port_draw_4096"] == 1, f"the sample draw is not reproducible: {repeats}")
    emit("two_camera_register", rot_err_deg=rot, t_err_mm=tr, rot_gate_deg=ROT_GATE_DEG,
         t_gate_mm=T_GATE_MM, valid_points=[int(c.mask.sum()) for c in rclouds],
         k7_launches=k7_launches, bit_identical_calls=same,
         distinct_results_of_8_calls=repeats)
    del rclouds, reg, clouds_o

    # phase 30: times (CUDA events, in turns): the merge in float32 and uint8
    # and its stages; K7 on the merge's pass 1 and pass 2 and its plain
    # version; K6 on the 5 MP passes, its plain version and torch.bmm of
    # the payload with a prebuilt float32 one-hot (TF32 off)
    decoded = [twocam._decode(f, c, cfg, dec) for f, c in ((f1, c1), (f2, c2))]
    edges = [twocam._code_edge_mask(r.x_p, r.y_p, r.mask, 3.0) for r in decoded]

    def invert_both():
        return [twocam.invert_to_projector(r.x_p, r.y_p, r.mask & e, r.quality, f[0],
                                           PROJ_W, PROJ_H)
                for r, e, f in zip(decoded, edges, (f1, f2))]

    def k7_args(i):
        a, kw = k7_calls[i]
        return (*a, kw["gates"], kw["dmin"], kw["dmax"])

    (code6, valid6, ch6, K6, *rest), kw6 = k6_calls[0]
    lo6, hi6, pay6, _ = kx.crossing_pairs(code6, valid6, ch6, *rest,
                                          pair_gate=kw6["pair_gate"])
    R6, N6, U6 = pay6.shape
    onehot = ((lo6[:, :, None] <= torch.arange(K6, dtype=torch.float32, device=dev))
              & (hi6[:, :, None] > torch.arange(K6, dtype=torch.float32, device=dev))
              ).to(torch.float32)                                   # (R, U, K)
    bmm = torch.bmm(pay6, onehot)
    plain_k6 = kx.crossing_bin_sum_reference(lo6, hi6, pay6, K6)
    torch.cuda.synchronize()
    check(float((bmm - plain_k6).abs().max()) <= 1e-4, "torch.bmm yardstick")
    runs = {
        "merge": lambda: merge(f1, f2, c1, c2),
        "merge_uint8": lambda: merge(*frames["uint8"], c1, c2),
        "decode_2x_k1": lambda: [twocam._decode(f, c, cfg, dec)
                                 for f, c in ((f1, c1), (f2, c2))],
        "edge_masks": lambda: [twocam._code_edge_mask(r.x_p, r.y_p, r.mask, 3.0)
                               for r in decoded],
        "invert_both": invert_both,
        "k7_4x": lambda: [kx.launch_interp_fused(*k7_args(i)) for i in range(4)],
        "k7_pass1": lambda: kx.launch_interp_fused(*k7_args(0)),
        "k7_pass2": lambda: kx.launch_interp_fused(*k7_args(1)),
        "plain_k7_pass1": lambda: kx.crossing_interp_fused_reference(*k7_args(0)),
        "plain_k7_pass2": lambda: kx.crossing_interp_fused_reference(*k7_args(1)),
        "k6_5mp_pass1": lambda: kx.launch_bin_sum(lo6, hi6, pay6, K6),
        "plain_k6_5mp_pass1": lambda: kx.crossing_bin_sum_reference(lo6, hi6, pay6, K6),
        "bmm_k6_5mp_pass1": lambda: torch.bmm(pay6, onehot),
        "merge_tiled_5mp": lambda: merge(tf1, tf2, t1, t2),
    }
    turns = [("merge", "merge_uint8", "merge_uint8", "merge"),
             ("decode_2x_k1", "edge_masks", "invert_both", "k7_4x", "k7_4x",
              "invert_both", "edge_masks", "decode_2x_k1"),
             ("plain_k7_pass1", "k7_pass1", "k7_pass1", "plain_k7_pass1"),
             ("plain_k7_pass2", "k7_pass2", "k7_pass2", "plain_k7_pass2"),
             ("plain_k6_5mp_pass1", "k6_5mp_pass1", "bmm_k6_5mp_pass1", "bmm_k6_5mp_pass1",
              "k6_5mp_pass1", "plain_k6_5mp_pass1"),
             ("merge_tiled_5mp", "merge_tiled_5mp")]
    heavy = {"plain_k6_5mp_pass1", "bmm_k6_5mp_pass1", "merge_tiled_5mp", "plain_k7_pass1",
             "plain_k7_pass2"}
    times = {k: [] for k in runs}
    for turn in turns:
        for name in turn:
            n_runs = 5 if name in heavy else TIMED_RUNS // 2
            times[name] += cuda_ms(runs[name], n_runs, 1 if name in heavy else 3)
    # each kernel's device time: GRAPH_LAUNCHES launches replayed from a
    # CUDA graph (no host time between them), in turns; its grid; the
    # host time of one K7 launch through its wrapper
    device = {k: [] for k in ("k7_pass1", "k7_pass2", "k6_5mp_pass1")}
    for name in (*device, *reversed(device)):
        device[name] += graph_ms(runs[name])
    def k7_shape(i):
        code, _, ch, K, interp = k7_args(i)[:5]
        return list(kx.launch_shape("K7", *code.shape, ch.shape[0], K, interp))

    shapes = {"k7_pass1": k7_shape(0), "k7_pass2": k7_shape(1),
              "k6_5mp_pass1": list(kx.launch_shape("K6", R6, U6, N6, K6))}
    k7_host_ms = host_ms(runs["k7_pass1"])
    del onehot, bmm, plain_k6
    torch.cuda.empty_cache()
    ms = {k: statistics.median(v) for k, v in times.items()}
    dev_ms = {k: statistics.median(v) for k, v in device.items()}
    regs = {"k7_merge_layout": next(v for k, v in ptxas.items()
                                    if "interp_fused_kernelILi4ELi3" in k),
            "k7_any_layout": next(v for k, v in ptxas.items() if "interp_fused_kernelILi8" in k),
            "k6": next(v for k, v in ptxas.items() if "bin_sum_kernel" in k)}
    (a1, _), (a2, _) = k7_calls[0], k7_calls[1]
    def k7_needed(i):
        code, valid, ch, K, _, gates, dmin, dmax = k7_args(i)
        return crossing_k7_bytes_needed(kx, code, valid, ch, K, gates, dmin, dmax)

    moved = {"k7_pass1": k7_needed(0), "k7_pass2": k7_needed(1),
             "k6_5mp_pass1": crossing_k6_bytes_needed(lo6, hi6, N6, K6)}
    moved_all = {"k7_pass1": crossing_k7_bytes(*a1[0].shape, a1[3]),
                 "k7_pass2": crossing_k7_bytes(*a2[0].shape, a2[3]),
                 "k6_5mp_pass1": crossing_k6_bytes(R6, U6, N6, K6)}
    gbs = {k: b / (ms[k] * 1e-3) / 1e9 for k, b in moved.items()}
    invert_glue = ms["invert_both"] - ms["k7_4x"]
    # where a merge's time goes: torch.profiler over 3 float32 merges,
    # device (kernel and copy) rows only, against the host wall
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            merge(f1, f2, c1, c2)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            row = by_name.setdefault(ev.name, [0, 0.0])
            row[0] += 1
            row[1] += ev.time_range.elapsed_us() / 1e3
    device_ms = sum(v[1] for v in by_name.values()) / 3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    emit("profile_two_camera_merge", card=card, wall_ms=wall, device_ms=device_ms,
         device_busy_share=device_ms / wall,
         device_ops_per_merge=sum(v[0] for v in by_name.values()) / 3,
         top_device_ms_per_merge={n[:90]: [c / 3, t / 3] for n, (c, t) in top})
    emit("timing_two_camera", card=card, **{f"{k}_ms": v for k, v in ms.items()},
         **{f"{k}_ms_spread": [min(v), max(v)] for k, v in times.items()},
         runs_each={k: len(v) for k, v in times.items()},
         merge_stages_ms={"decode_2x_k1": ms["decode_2x_k1"], "edge_masks": ms["edge_masks"],
                          "k7_4x": ms["k7_4x"], "inversion_glue": invert_glue,
                          "triangulation_glue": ms["merge"] - ms["decode_2x_k1"]
                          - ms["edge_masks"] - ms["invert_both"]},
         merge_host_ms=host_ms(runs["merge"], 10),
         **{f"{k}_bytes": b for k, b in moved.items()},
         bytes_of="least traffic on this run's data (channels and payload only where a "
                  "pair crosses a bin)",
         **{f"{k}_bytes_all_inputs": b for k, b in moved_all.items()},
         **{f"{k}_gb_s": v for k, v in gbs.items()},
         **{f"{k}_hbm_share": v / (HBM_PEAK_TBS * 1e3) for k, v in gbs.items()},
         k7_pass_shapes=[[*a1[0].shape, a1[3]], [*a2[0].shape, a2[3]]],
         k6_pass1_shape=[R6, N6, U6, K6],
         device_ms=dev_ms, device_ms_spread={k: [min(v), max(v)] for k, v in device.items()},
         device_timing=f"CUDA graph of {GRAPH_LAUNCHES} launches, replayed in turns",
         device_hbm_share={k: moved[k] / (dev_ms[k] * 1e-3) / (HBM_PEAK_TBS * 1e12)
                           for k in dev_ms},
         grid_blocks_per_sm=shapes, registers=regs, k7_host_launch_ms=k7_host_ms,
         after=nvidia_smi("clocks.sm,power.draw,temperature.gpu"))
    return [{
        "name": "crossing_interp_fused", "route": "cuda",
        "source": "slr_torch/kernels/csrc/crossing.cu",
        "replaces": "slr/kernels/crossing.py:269",
        "launches": k7_launches, "max_abs_err": k7_err,
        "max_abs_err_of": "cnt and interpolated values against the plain version",
        "ms": ms["k7_pass1"], "plain_ms": ms["plain_k7_pass1"],
        "plain_of": "payload build, each bin summed in the kernels' ascending pair "
                    "order (not a one-hot einsum), unpack",
        "bound_ms": moved["k7_pass1"] / (HBM_PEAK_TBS * 1e12) * 1e3, "bound_by": "bytes",
        "library_ms": None,
        "ms_pass2": ms["k7_pass2"], "plain_ms_pass2": ms["plain_k7_pass2"],
        "bound_ms_pass2": moved["k7_pass2"] / (HBM_PEAK_TBS * 1e12) * 1e3,
        "bound_ms_all_inputs": moved_all["k7_pass1"] / (HBM_PEAK_TBS * 1e12) * 1e3,
        "bound_ms_all_inputs_pass2": moved_all["k7_pass2"] / (HBM_PEAK_TBS * 1e12) * 1e3,
        "ms_of": "CUDA events around one launch through the wrapper (host time included)",
        "device_ms": dev_ms["k7_pass1"], "device_ms_pass2": dev_ms["k7_pass2"],
        "host_launch_ms": k7_host_ms, "registers": regs["k7_merge_layout"],
        "grid_blocks_per_sm": shapes["k7_pass1"],
    }, {
        "name": "crossing_bin_sum", "route": "cuda",
        "source": "slr_torch/kernels/csrc/crossing.cu",
        "replaces": "slr/kernels/crossing.py:149",
        "launches": k6_launches, "max_abs_err": k6_err,
        "max_abs_err_of": "cnt and interpolated values through crossing_interp against "
                          "its plain route",
        "ms": ms["k6_5mp_pass1"], "plain_ms": ms["plain_k6_5mp_pass1"],
        "plain_of": "each bin summed in the kernels' ascending pair order (not a "
                    "one-hot einsum)",
        "bound_ms": moved["k6_5mp_pass1"] / (HBM_PEAK_TBS * 1e12) * 1e3,
        "bound_by": "bytes", "library_ms": ms["bmm_k6_5mp_pass1"],
        "library": "torch.bmm of the float32 payload with a prebuilt float32 one-hot",
        "ms_of": "CUDA events around one launch through the wrapper (host time included)",
        "bound_ms_all_inputs": moved_all["k6_5mp_pass1"] / (HBM_PEAK_TBS * 1e12) * 1e3,
        "device_ms": dev_ms["k6_5mp_pass1"], "registers": regs["k6"],
        "grid_blocks_per_sm": shapes["k6_5mp_pass1"],
    }]


def main():
    wall_start = time.perf_counter()
    # phase 1: the card
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on an NVIDIA GPU")
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    emit("device", nvidia_smi=card, torch=torch.__version__,
         cuda=torch.version.cuda)

    from slr_torch.codec import unwrap as pu
    from slr_torch.codec.patterns import decode_stack
    from slr_torch.config import DecodeConfig, PatternConfig
    from slr_torch.entry import entry
    from slr_torch.geom.camera import make_camera
    from slr_torch.kernels import band_nn as kb
    from slr_torch.kernels import crossing as kx
    from slr_torch.kernels import fused_scan as fs
    from slr_torch.kernels import unwrap_scan as us
    from slr_torch.kernels import wavefront as wf
    from slr_torch.kernels.build import build_library
    from slr_torch.pipeline.reconstruct import (
        SPATIAL_MODES, DenseReconstructor, accumulate_by_projector, spatial_repair)
    from slr_torch.synth.render import default_rig, quantize_frames, render_scan
    from slr_torch.synth.scene import bumps_depth, checker_albedo

    kernel = fs.fused_decode_triangulate
    kernel_hdr = fs.fused_decode_triangulate_hdr
    # every kernel wrapper's launch count, by kernel
    wrappers = {"k1": kernel, "k2": kernel_hdr, "k3": us.quality_unwrap,
                "k4": us.quality_unwrap_tiled, "k5": wf.wavefront_pass,
                "k8": kb.band_nn_sorted, "k6": kx.crossing_bin_sum,
                "k7": kx.crossing_interp_fused}
    dev = torch.device("cuda")
    dec = DecodeConfig()
    # points_max_abs_err (K1, K2), |dPhi| (K3-K5) of every comparison
    errs = {"k1": [], "k2": [], "k3": [], "k4": [], "k5": []}

    def counts_of(fn):
        """Run ``fn`` with every launch count set to 0 just before; returns
        (result, {kernel: launches}) read just after."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k: w.launches for k, w in wrappers.items()}

    def counted(fn):
        """``counts_of`` for a scan path without the spatial repair: checks
        that K3-K5 did not launch; returns (result, K1, K2 launches)."""
        out, n = counts_of(fn)
        check(n["k3"] == n["k4"] == n["k5"] == 0, f"spatial kernels launched: {n}")
        return out, n["k1"], n["k2"]

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

    # phase 2: build the kernels from the checkout's sources (set-up time),
    # one nvcc per source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = dict(zip(LIBRARIES, pool.map(build_library, LIBRARIES)))
    fs._library()
    us.library()
    kb.library()
    kx.library()
    emit("build", setup_s=time.perf_counter() - t0,
         library={k: p.name for k, (p, _) in built.items()},
         ptxas={k: ptxas_summary(log) for k, (_, log) in built.items()})

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

    # phase 15: the voting kernels K3 and K4 against the plain sweep, bit for
    # bit: the reference's 400-error scene at 1280x1024 (as
    # benchmarks/tpu_matrix.py:241-249), and a ragged 300x215 map with holes
    # in its mask and errors on its borders
    def phase_scene(H, W, seed, n_bad, partial=False, blob=None):
        """(clean Phi, Phi with errors 3 orders off, quality, mask, bad)
        on the card, from numpy's generator."""
        rng = np.random.default_rng(seed)
        Phi = np.linspace(0, 60, W)[None, :] + 0.1 * rng.normal(size=(H, W))
        bad = np.zeros((H, W), bool)
        bad[rng.integers(1, H - 1, n_bad), rng.integers(1, W - 1, n_bad)] = True
        mask = np.ones((H, W), bool)
        if partial:
            mask = rng.random((H, W)) > 0.1
            bad[0, ::7] = bad[H - 1, ::5] = bad[::6, 0] = bad[::4, W - 1] = True
        if blob is not None:
            bad[blob] = True
        q = np.where(bad, 0.05, 1.0).astype(np.float32)
        Phi_n = np.where(bad, Phi + 2 * np.pi * 3, Phi).astype(np.float32)
        return [torch.from_numpy(a).to(dev) for a in
                (Phi.astype(np.float32), Phi_n, q, mask, bad)]

    voting = {}
    for name, scene in (("1280x1024", phase_scene(CAM_H, CAM_W, 0, 400)),
                        ("300x215", phase_scene(215, 300, 1, 300, partial=True))):
        Phi_c, Phi_n, q, mask, bad = scene
        for iters in (6, 8):
            plain = pu.spatial_quality_unwrap(Phi_n, q, mask, iters)
            k3 = us.launch_vote_resident(Phi_n, mask, iters)
            k4 = us.quality_unwrap_tiled(Phi_n, q, mask, iters)
            torch.cuda.synchronize()
            check(torch.equal(k3, plain), f"K3 {name} iters {iters}: not bit-equal")
            check(torch.equal(k4, plain), f"K4 {name} iters {iters}: not bit-equal")
            check(torch.equal(k3, k4), f"K3 vs K4 {name} iters {iters}")
            errs["k3"].append(float((k3 - plain).abs().max()))
            errs["k4"].append(float((k4 - plain).abs().max()))
            fixed_err = float((k4 - Phi_c)[bad].abs().max())
            if not name.startswith("300"):
                check(fixed_err < BLOB_TOL, f"{name}: seeded errors left, {fixed_err}")
            voting[f"{name}_iters{iters}"] = dict(
                bit_equal=True, seeded_max_abs_err=fixed_err,
                repaired=int(((k4 - Phi_n).abs() > 1.0).sum()), seeded=int(bad.sum()))
    emit("k3_k4_voting", **voting)

    # phase 16: K5 against its plain pass: the light repair (8 launches),
    # 4 levels x 2 rounds (32), the phase-only unwrap (32); the scene above,
    # and with a 6x8 blob added
    Phi_c, Phi_n, q, mask, bad = phase_scene(CAM_H, CAM_W, 0, 400)
    blob_scene = phase_scene(CAM_H, CAM_W, 0, 400,
                             blob=(slice(500, 506), slice(600, 608)))
    wave = {}

    def versus_plain_wavefront(name, want, phi, q, mask, Phi_init=None, trust=None,
                               clean=None, **kw):
        (out, reached), n = counts_of(lambda: wf.wavefront_unwrap(
            phi, q, mask, Phi_init=Phi_init, trust=trust, **kw))
        check(n["k5"] == want and n["k1"] == n["k3"] == n["k4"] == 0,
              f"{name}: launches {n}")
        ref, reached_ref = pu.quality_guided_unwrap(phi, q, mask, Phi_init=Phi_init,
                                                    trust=trust, **kw)
        check(torch.equal(reached, reached_ref), f"{name}: reached maps differ")
        err = float((out - ref)[reached].abs().max())
        check(err <= WAVEFRONT_TOL, f"{name}: |dPhi| {err} rad")
        errs["k5"].append(err)
        wave[name] = dict(launches=n["k5"], max_abs_err=err,
                          bit_equal=bool(torch.equal(out, ref)),
                          reached=float(reached.float().mean()))
        if clean is not None:
            fixed = float((out - clean).abs().max())
            check(fixed < BLOB_TOL, f"{name}: errors left, {fixed}")
            wave[name]["vs_clean_max_abs_err"] = fixed

    for sname, (c, P, qq, mm, _) in (("", (Phi_c, Phi_n, q, mask, bad)),
                                     ("_blob", blob_scene)):
        phi_w, trust = pu.repair_trust(P, qq, mm)
        versus_plain_wavefront("repair" + sname, 8, phi_w, qq, mm, P, trust,
                               clean=c, levels=2, rounds_per_level=1)
        versus_plain_wavefront("repair_4x2" + sname, 32, phi_w, qq, mm, P, trust,
                               clean=c, levels=4, rounds_per_level=2)
    versus_plain_wavefront("phase_only", 32, torch.remainder(Phi_n, 2 * math.pi),
                           q, mask, levels=4, rounds_per_level=2)
    emit("k5_wavefront", **wave)

    # phase 17: the spatial repair on the main path: DenseReconstructor with
    # spatial_iters=4 on the config-3 scan, both modes (K1 + K4, or K1 + K5
    # x 8), then the voting mode on a 320x256 camera (noise 0.01), whose map
    # takes K3; the mask stays the unrepaired one; the repaired pixels are
    # those of the plain route (the same function on the host)
    small_cam, small_proj = default_rig(cam_w=320, cam_h=256, proj_w=256, proj_h=192,
                                        device=dev)
    small_cfg = PatternConfig(proj_width=256, proj_height=192, gray_bits=6,
                              phase_steps=4)
    small_scan = render_scan(small_cam, small_proj, bumps_depth(
        256, 320, base=480.0, amp=25.0, device=dev), small_cfg, noise_std=0.01,
        generator=torch.Generator(device="cuda").manual_seed(9))
    spatial, spatial_launches = {}, {"k3": 0, "k4": 0, "k5": 0}
    spatial_runs = [(mode, cam, proj, cfg, frames, scan,
                     (0, 1, 0) if mode == "voting" else (0, 0, 8))
                    for mode in SPATIAL_MODES]
    spatial_runs.append(("voting_320x256", small_cam, small_proj, small_cfg,
                         small_scan.frames, small_scan, (1, 0, 0)))
    for mode, c_cam, c_proj, c_cfg, c_frames, c_scan, want in spatial_runs:
        base, n = counts_of(lambda: DenseReconstructor(c_cam, c_proj, c_cfg).to(dev)(c_frames))
        check(n["k1"] == 1 and n["k3"] + n["k4"] + n["k5"] == 0, f"{mode} base: {n}")
        model = DenseReconstructor(c_cam, c_proj, c_cfg, DecodeConfig(
            spatial_unwrap_mode=mode.split("_")[0]), spatial_iters=SPATIAL_ITERS).to(dev)
        out, n = counts_of(lambda: model(c_frames))
        check((n["k1"], n["k2"], n["k3"], n["k4"], n["k5"]) == (1, 0, *want),
              f"{mode}: launches {n}")
        for k in spatial_launches:
            spatial_launches[k] += n[k]
        launches += n["k1"]
        H, W = c_frames.shape[-2:]
        check(tuple(out.points.shape) == (H, W, 3)
              and bool(torch.isfinite(out.points).all()), f"{mode} points")
        check(torch.equal(out.mask, base.mask), f"{mode}: the mask changed")
        rms_s, n_s = rms_vs_truth(out.points, out.mask, c_scan)
        rms_b, _ = rms_vs_truth(base.points, base.mask, c_scan)
        gate = RMS_GATE_MM if c_cfg is cfg else 0.5
        check(rms_s <= gate, f"{mode}: RMS {rms_s} mm > {gate}")
        pitch = c_cfg.fringe_pitch
        repaired = (out.x_p - base.x_p).abs() > pitch / 2
        _, plain_repaired = spatial_repair(base.x_p.cpu(), base.quality.cpu(),
                                           base.mask.cpu(), pitch, SPATIAL_ITERS,
                                           mode.split("_")[0])
        check(torch.equal(repaired.cpu(), plain_repaired),
              f"{mode}: repaired set differs from the plain route's")
        keep = ~repaired
        check(torch.equal(out.x_p[keep], base.x_p[keep])
              and torch.equal(out.points[keep], base.points[keep]),
              f"{mode}: unrepaired pixels moved")
        # each repaired pixel's error against the ground truth, before and after
        seen = repaired & c_scan.mask_true
        err = [torch.linalg.norm(x.points - c_scan.points_true, dim=-1)[seen]
               for x in (base, out)]
        spatial[mode] = dict(launches=n, rms_mm=rms_s, rms_unrepaired_mm=rms_b,
                             rms_gate_mm=gate, valid_points=n_s,
                             repaired_px=int(repaired.sum()),
                             repaired_closer=int((err[1] < err[0]).sum()),
                             repaired_farther=int((err[1] > err[0]).sum()),
                             repaired_err_mm_before_after=[
                                 float(e.max()) if e.numel() else 0.0 for e in err],
                             frames=list(c_frames.shape))
    check(spatial["voting_320x256"]["repaired_px"] > 0, "no repair on the noisy scan")
    emit("reconstruct_dense_spatial", spatial_iters=SPATIAL_ITERS, **spatial)

    # phase 18: times, in turns (plain, kernel, scan, scan, kernel, plain)
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
    turns = [tuple(n + sfx for n in ("plain", "kernel", "scan", "scan", "kernel", "plain"))
             for sfx in ("", "_uint8", "_hdr")]
    # the spatial repair on the config-3 decode's own map: K3 and K4 at 4
    # and 8 sweeps, one K5 pass along rows and along columns (the repair's
    # last level: every masked pixel eligible, the trusted ones done), the
    # 8-pass repair, and the forward in each mode
    base = model(frames)
    pitch = cfg.fringe_pitch
    Phi3, q3, m3 = base.x_p * (2 * math.pi / pitch), base.quality, base.mask
    phi3, trust3 = pu.repair_trust(Phi3, q3, m3)
    models = {mode: DenseReconstructor(cam, proj, cfg, DecodeConfig(
        spatial_unwrap_mode=mode), spatial_iters=SPATIAL_ITERS).to(dev)
        for mode in SPATIAL_MODES}
    for it in (SPATIAL_ITERS, 8):
        runs.update({
            f"plain_vote{it}": lambda it=it: pu.spatial_quality_unwrap(Phi3, q3, m3, it),
            f"k3_{it}": lambda it=it: us.launch_vote_resident(Phi3, m3, it),
            f"k4_{it}": lambda it=it: us.launch_vote_tiled(Phi3, m3, it)})
        turns.append((f"plain_vote{it}", f"k3_{it}", f"k4_{it}", f"k4_{it}",
                      f"k3_{it}", f"plain_vote{it}"))
    for axis, line in ((1, "rows"), (0, "cols")):
        runs.update({
            f"plain_pass_{line}": lambda axis=axis: pu.directional_pass(
                phi3, m3, Phi3, trust3, axis, False),
            f"k5_{line}": lambda axis=axis: wf.launch_wavefront_pass(
                phi3, m3, Phi3, trust3, axis, False)})
        turns.append((f"plain_pass_{line}", f"k5_{line}", f"k5_{line}",
                      f"plain_pass_{line}"))
    runs.update({
        "plain_repair": lambda: pu.quality_guided_repair(Phi3, q3, m3, levels=2,
                                                         rounds_per_level=1),
        "repair": lambda: wf.wavefront_repair(Phi3, q3, m3),
        "scan_voting": lambda: models["voting"](frames),
        "scan_wavefront": lambda: models["wavefront"](frames)})
    turns += [("plain_repair", "repair", "repair", "plain_repair"),
              ("scan_voting", "scan_wavefront", "scan_wavefront", "scan_voting")]
    times = {k: [] for k in runs}
    for turn in turns:
        for name in turn:
            times[name] += cuda_ms(runs[name])
    ms = {k: statistics.median(v) for k, v in times.items()}
    spread = {f"{k}_ms_spread": [min(v), max(v)] for k, v in times.items()}
    px = CAM_H * CAM_W
    tiles = -(-CAM_W // us.TILE_W) * -(-CAM_H // 64)
    moved = {"kernel": (4 * cfg.num_frames + 7 * 4) * px,
             "kernel_uint8": (cfg.num_frames + 7 * 4) * px,
             "kernel_hdr": hdr_bytes,
             # K3: phi and mask in, out (and scratch) written once; the
             # sweeps between run in L2
             **{f"k3_{it}": (4 + 1 + 4 + 4) * px for it in (SPATIAL_ITERS, 8)},
             # K4: phi and mask of every tile with its halo in, the map out
             **{f"k4_{it}": tiles * (64 + 2 * it) ** 2 * 5 + 4 * px
                for it in (SPATIAL_ITERS, 8)},
             # K5: phi, Phi (4 B), elig, done (1 B) in; Phi, done out
             "k5_rows": 15 * px, "k5_cols": 15 * px}
    gbs = {f"{k}_gb_s": b / (ms[k] * 1e-3) / 1e9 for k, b in moved.items()}
    host = {f"{k}_host_ms": host_ms(fn) for k, fn in (
        ("scan_params", lambda: fs.scan_params(cam_d, proj_d, cfg, dec,
                                               (1.0, 1e4), 8, CAM_H, CAM_W)),
        ("launch", runs["kernel"]), ("scan", runs["scan"]))}
    emit("timing", card=card, runs_each=len(times["kernel"]),
         **{f"{k}_ms": v for k, v in ms.items()}, **host, **spread,
         **{f"{k}_bytes": b for k, b in moved.items()}, **gbs,
         hbm_peak_gb_s=HBM_PEAK_TBS * 1e3,
         **{k.replace("gb_s", "hbm_share"): v / (HBM_PEAK_TBS * 1e3)
            for k, v in gbs.items()},
         after=nvidia_smi("clocks.sm,power.draw,temperature.gpu"))

    # phases 19-23: registration (config 4), K8
    k8_entry = registration_phases(dev, cam, proj, cfg, counts_of, card)

    # phases 24-30: the two-camera merge, K7 and K6
    k7_entry, k6_entry = two_camera_phases(dev, counts_of, card,
                                           ptxas_summary(built["crossing"][1]))

    def bound(nbytes=0, instr=0):
        """The least time (ms) for ``nbytes`` of HBM traffic and ``instr``
        fp32 instructions, and which of the two binds."""
        t_b, t_i = nbytes / (HBM_PEAK_TBS * 1e12), instr / FP32_ISSUE_PER_S
        return {"bound_ms": max(t_b, t_i) * 1e3,
                "bound_by": "bytes" if t_b >= t_i else "operations"}

    vote_instr = VOTE_INSTR_PER_PX_SWEEP * px * SPATIAL_ITERS
    emit("wall", s=time.perf_counter() - wall_start)

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
        **bound(moved["kernel"]), "library_ms": None,
        "bound_ms_uint8": bound(moved["kernel_uint8"])["bound_ms"],
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
        **bound(moved["kernel_hdr"]), "library_ms": None,
    }, {
        "name": "quality_unwrap",
        "route": "cuda",
        "source": "slr_torch/kernels/csrc/unwrap.cu",
        "replaces": "slr/kernels/unwrap_scan.py:34",
        "launches": spatial_launches["k3"],
        "max_abs_err": max(errs["k3"]),
        "ms": ms[f"k3_{SPATIAL_ITERS}"],
        "plain_ms": ms[f"plain_vote{SPATIAL_ITERS}"],
        "ms_iters8": ms["k3_8"],
        "plain_ms_iters8": ms["plain_vote8"],
        **bound(moved[f"k3_{SPATIAL_ITERS}"], vote_instr), "library_ms": None,
    }, {
        "name": "quality_unwrap_tiled",
        "route": "cuda",
        "source": "slr_torch/kernels/csrc/unwrap.cu",
        "replaces": "slr/kernels/unwrap_scan.py:46",
        "launches": spatial_launches["k4"],
        "max_abs_err": max(errs["k4"]),
        "ms": ms[f"k4_{SPATIAL_ITERS}"],
        "plain_ms": ms[f"plain_vote{SPATIAL_ITERS}"],
        "ms_iters8": ms["k4_8"],
        "plain_ms_iters8": ms["plain_vote8"],
        **bound(moved[f"k4_{SPATIAL_ITERS}"], vote_instr), "library_ms": None,
    }, {
        "name": "wavefront_pass",
        "route": "cuda",
        "source": "slr_torch/kernels/csrc/unwrap.cu",
        "replaces": "slr/kernels/wavefront.py:53",
        "launches": spatial_launches["k5"],
        "max_abs_err": max(errs["k5"]),
        "ms": ms["k5_rows"],
        "plain_ms": ms["plain_pass_rows"],
        "ms_cols": ms["k5_cols"],
        "plain_ms_cols": ms["plain_pass_cols"],
        "ms_repair_8_passes": ms["repair"],
        "plain_ms_repair_8_passes": ms["plain_repair"],
        **bound(moved["k5_rows"]), "library_ms": None,
    }, k8_entry, k7_entry, k6_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
