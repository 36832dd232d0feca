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
both fusions; and on brackets whose chosen exposure changes inside most
staged boxes, uint16, float32, ragged and unaligned ones), and the spatial
repair (``spatial_iters=4``: voting, K4 at this size and K3 on a 320x256
and a 1280x800 camera, both held to the plain sweep bit for bit also on
ragged and unaligned maps, float32 ties of the rounding, signed zeros,
|Phi| ~ 1e6 and masks holed along K4's tile and warp edges, at 1 to 17
sweeps, K3 also on the largest maps its route takes at up to 64 sweeps and
in 20 launches back to back, and refusing a map past one wave of its
tiles, while ``quality_unwrap`` sends a map within the budget but past one
wave to K4; wavefront, K5, held to its plain pass bit for bit on every
case), and the projector's optics (defocus and gamma) decoded by K1. Then registration (config 4): the sorted-band
search K8 at 256k points, point-to-plane ICP on its band route
(``icp_point_to_plane``) at 256k (and the same case on the voxel route) and
between two dense scans,
and ``register_scans`` on a 4-scan orbit, each registration twice and held
to the same bits. Then config 5 on the reference's 8-scan orbit (K1 eight
times, ``register_scans_batched``, ``ba_refine``, ``fuse_scans``,
``fuse_tsdf``, ``extract_mesh`` and the OBJ writer), gated on poses, the
fused cloud and the mesh against the truth, twice to the same bits, each
stage's wall; the pose graph's and the ICP's kernels (one launch a
solve, one launch a round on each ICP route) against their plain versions
on the card. Then the two-camera merge (``reconstruct_two_camera``):
the crossing kernels K7 and K6 against their plain versions, bit for bit
(the reference's random case, a ragged one, the merge's passes and the 5 MP
calls; rows with long pair ranges, NaN and infinite codes, clipped bins,
unaligned rows, few and many rows, the widest row a block holds, rows
past it in chunks of pairs (K6), and
channel layouts other than the merge's), the merge at full width in float32 and uint8 (K1 twice, K7 four times; RMS and
cells equal to the recorded digits), the tiled route on a 5 MP sensor (K6
four times), the splat and search oracles, and two merged rig poses
registered, twice (with the sample draw's ops repeated on the same
inputs). Then calibration (config 2), which runs no kernel: the
reference's 24-view Zhang and stereo solves (``benchmarks/tpu_matrix.py``)
and the CLI's image route at 1280x1024 (8 rendered board views: corners
detected, patterns decoded, corners lifted into the projector, camera,
projector and stereo LM) under the reference's golden gates, twice to the
same bits. Then the product surface (the session, the stream, the CLI,
the viewer), and the parallel tier (``slr_torch.dist``), whose ranks are
subprocesses of this script (``--dist-rank``): a one-rank NCCL group and
four Gloo ranks sharing the card drive config 3 through
``sharded_reconstruct`` (K1 at each rank's row offset, K3/K4 on its haloed
block), the distributed BA and config 5 over a 2 x 2 layout, each held to
the unsharded bits or bounds. Each path's output is
checked against the synthetic ground truth and its launches counted; then the kernels, their
plain versions and the paths are timed with CUDA events (every kernel also
by device time, from CUDA-graph replays (K3's cooperative launch too);
K6 and K7 with their registers, blocks an SM and K7's host launch time),
and the whole run's wall time is printed.
Each phase prints one JSON line; the last line is ``{"ok": true, "device":
{...}}``. Any failed check ends the run with a traceback and a non-zero
exit, as does a machine without a CUDA device. Imports nothing of JAX."""

import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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
HDR_GAINS = (1.0, 3.2, 10.0)
PROJ_DIST = [-0.08, 0.02, 0.001, -0.001, 0.0]
# csrc/<name>.cu, one nvcc each
LIBRARIES = ("fused_scan", "unwrap", "band_nn", "crossing", "obj_text", "pose_graph", "icp")
K1_UINT8_RMS_RECORDED = "0.0463"   # mm, config 3 uint8 (PERF.md)
# K1's layouts, at 215 rows (the last 2-row box partial): rows of 299 and
# 301 uint8 or uint16 pixels, not a multiple of 16 bytes, so no box is
# staged; 1296 = 10 * 128 + 16 columns, rows aligned, a partial last
# 128-column box
K1_LAYOUT_WIDTHS = (299, 301, 1296)
# K5 alone against its plain pass: (H, W, offset of each map in its buffer)
K5_CASES = ((2048, 2448, 0), (215, 300, 0), (1037, 1283, 0), (9000, 40, 0),
            (3, 10240, 0), (64, 1280, 1))
BLOB_TOL = 1e-3            # rad, a repaired map against the clean phase
SPATIAL_ITERS = 4
VOTE_ITERS = (1, 4, 8, 9, 17)   # sweeps of the voting kernels' layout cases
# K3 alone: (H, W) of the largest maps the route rule sends it, 1024x1024
# and 128x8192 (the most tiles), and a 1280x800 camera's; launches of its
# back-to-back batch
K3_MAPS = ((1024, 1024), (8192, 128), (800, 1280))
K3_BATCH = 20
K3_CAM_W, K3_CAM_H = 1280, 800   # a 1 MP sensor, whose repair takes K3
K3_TIMED_ITERS = (SPATIAL_ITERS, 8, 17)   # sweeps of K3 and K4 timed on the config-3 map
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
# config 5: the reference's 8-scan orbit, end to end (tpu_matrix.py:966-1049;
# config 4 registers its first ORBIT_SCANS): batched registration with 4096
# samples, BA on 512 landmarks, the voxel fuse and a 128^3 TSDF mesh
ORBIT_SCANS_CONFIG5 = 8
C5_SAMPLES, C5_LANDMARKS, C5_BA_ITERS = 4096, 512, 8
C5_VOXEL, C5_CAPACITY, C5_TSDF = 2.0, 1 << 20, (128, 128, 128)
C5_RMS_POINTS = 8192                  # fused points held to the truth union
C5_FUSED_GATE_MM = 2.5                # the reference's ok rule (tpu_matrix.py:1044-1045)
C5_MIN_FACES = 1000                   # tpu_matrix.py:961
C5_BA_RMS_GATE = 1.5                  # tests/test_pipeline.py:209
# the port's own gates, from the reference's readings on this orbit
# (BASELINE.md:155-160: poses to 0.080 mm, the fused cloud 0.103 mm RMS)
C5_T_TIGHT_MM, C5_FUSED_TIGHT_MM = 0.5, 0.25
C5_MESH_GATE_MM = 2.0                 # mesh vertices to the truth union: one voxel edge
# a pair costs K8 8 fp32 instructions (3 sub, 3 mul, 2 add; no FMA)
K8_INSTR_PER_PAIR = 8
# the OBJ text formatter's digit of a 32-bit value: obj_write_kernel's
# digit loop in its sm_90a SASS (cuobjdump -sass), unrolled by 4, issues 30
# instructions for 4 digits (a multiply-high, a shift, the remainder, the
# '0', the store); the card issues 16.7e12 integer instructions a second
# (64 INT32 lanes an SM, 132 SMs, 1.98 GHz)
OBJ_DIGIT_INSTR, INT32_ISSUE_PER_S = 7.5, 16.7e12
OBJ_HEADER = b"# slr tsdf mesh export\n"
# bounds: instructions of one strict-consensus sweep a pixel, the least
# work of the function (the operations of csrc/unwrap.cu's edge_vote,
# vote_round and vote_consensus). A sweep rounds 2 edges a pixel, the one
# below it and the one to its right, each negated for the edge's other end
# (a negation folds into the compare that reads it). An edge's vote, 9: the
# subtraction, the edge's mask test, the NaN select, the reciprocal product
# and two FMAs, the inf guard, its select and the rint. The consensus, 12: 5
# equality compares, the 2-of-3 logic, the select of the vote, its != 0
# test, the take logic, the multiply, the add and the select of the new Phi.
# 30 in all, one bound for K3 and K4, which compute the same sweep; what a
# design adds is not counted (K4: 2 shuffles, 32; K3: 4 roundings, not 2, 48,
# and its index arithmetic and loads). Both are bound by these, not by their
# bytes
VOTE_INSTR_PER_PX_SWEEP = 2 * 9 + 12
# K5's scan: instructions of a compose whose y is CHAIN, counted from the
# source's operations: with an upstream x that is not KILL, 19 (the two
# tags' extraction and tests, a subtraction, the reciprocal product and two
# FMAs, the rounding's two guards and select, a rint, a multiply and an
# add, the ps select and the tag update); with a KILL x, 7 (the tag tests
# and update only). A y that is not CHAIN is never composed: the kernel
# skips it, and a thread or warp without CHAIN skips the step. The bound
# counts the composes that the timed map needs (wave_tree_composes)
WAVE_INSTR_CHAIN = 19
WAVE_INSTR_CHAIN_KILL = 7
# two-camera merge (slice 5): the reference's full-width case
# (benchmarks/tpu_matrix.py:453-478)
TWO_CAM_RMS_GATE_MM = 0.05
TWO_CAM_MIN_POINTS = 560_000
ORACLE_RMS_GATE_MM = 0.5              # tpu_matrix.py:511
TILED_W, TILED_H = 2448, 2048         # a 5 MP machine-vision sensor
K6_CHUNK_CASE = (4, 40_000, 7, 1024)  # R, U, N, K: rows past one K6 block
OPTICS = dict(defocus_sigma=1.0, proj_gamma=2.2)
# calibration (config 2): benchmarks/tpu_matrix.py:610-679's 24-view case and
# its gates, the reference's readings on those inputs (BASELINE.md:177-178)
# and how far the port may stray from them
V24_ZHANG_RMS, V24_STEREO_RMS, V24_RMS_TOL = 0.1376, 0.1397, 0.002
V24_T_ERR_MAX = 0.5                   # mm; the reference reads 0.173
# the CLI's image route at its own size: tests/test_calib.py:205-213's golden
# gates, :143-144's corner gates, and the reference's readings on it
CALIB_CAM = (1280, 1024, 1024, 768)
CALIB_GOLDEN = dict(rms_px=0.5, f_rel=0.01, c_px=5.0, R_abs=4e-3, t_abs_mm=2.0,
                    corner_max_px=0.8, corner_mean_px=0.4)
CALIB_REFERENCE = dict(rms_px=0.2143, cam_cx_off_px=4.15, max_dt_mm=0.26)
CALIB_STAGES = ("detect_chessboard", "decode_stack", "projector_corners_from_decode",
                "calibrate_camera", "calibrate_projector", "stereo_calibrate")
K3_OVERFLOW_MAP = (32, 32768)         # within the 12 MiB budget, past one wave of K3
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


def bound(nbytes=0, instr=0):
    """The least time (ms) for ``nbytes`` of HBM traffic and ``instr`` fp32
    instructions on an H100 (``slr_torch.observability.roofline``; an
    instruction issues as an FMA does, two flops), and which of the two
    binds."""
    from slr_torch.observability import roofline

    r = roofline(nbytes, 2 * instr, 1.0)
    return {"bound_ms": r["sol_ms"],
            "bound_by": "bytes" if r["bound"] == "memory" else "operations"}


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
    """Per-run span of one call of ``fn`` between two CUDA events, after
    warm-up: the start event is recorded, then ``fn`` runs on the host (a
    wrapper's checks, allocations and launch), then the end event. So a
    kernel's span includes the host time between the events, not only its
    device time (``graph_ms`` gives that)."""
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


def wave_maps(device, H, W, seed, offset=0):
    """(phi, elig, Phi, done) for one K5 pass, from numpy's generator: a
    noisy ramp wrapped, 2 % done, 85 % eligible; ``offset``: each map
    starts that many elements into a larger buffer (contiguous, unaligned)."""
    rng = np.random.default_rng(seed)
    Phi = np.cumsum(rng.normal(0.6, 0.8, size=(H, W)), axis=1).astype(np.float32)
    phi = np.mod(Phi, 2 * np.pi).astype(np.float32)
    done = rng.random((H, W)) < 0.02
    elig = rng.random((H, W)) < 0.85
    out = []
    for a in (phi, elig, np.where(done, Phi, phi).astype(np.float32), done):
        t = torch.from_numpy(a).to(device)
        buf = torch.empty(H * W + offset, dtype=t.dtype, device=device)
        buf[offset:] = t.reshape(-1)
        out.append(buf[offset:].view(H, W))
    return out


def wave_tree_composes(elig, done, axis):
    """The composes that one forward K5 pass along ``axis`` does on this
    data: the plain pass's Hillis-Steele tree replayed on the tags alone
    (2 CONST, 1 CHAIN, 0 KILL; a compose gives y x's tag where y is CHAIN).
    Returns (y CHAIN and x not KILL, y CHAIN and x KILL, every compose of
    the tree)."""
    tag = torch.where(done, 2, torch.where(elig, 1, 0)).to(torch.int8)
    n, lines = tag.shape[axis], tag.numel() // tag.shape[axis]
    arith = kill = every = 0
    s = 1
    while s < n:
        x, y = tag.narrow(axis, 0, n - s), tag.narrow(axis, s, n - s)
        chain = y == 1
        arith += int((chain & (x != 0)).sum())
        kill += int((chain & (x == 0)).sum())
        every += (n - s) * lines
        tag = torch.cat([tag.narrow(axis, 0, s), torch.where(chain, x, y)], axis)
        s <<= 1
    return arith, kill, every


def tie_values(a, quotients=(0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5)):
    """float32 values y near a + q 2pi whose difference from a, divided by
    2pi in float32, is exactly q: ties that rounding half to even breaks
    (0.5 -> 0, 1.5 -> 2, 2.5 -> 2). Some q have no such y near a."""
    tp, a = np.float32(2 * np.pi), np.float32(a)
    out = []
    for q in quotients:
        y0 = np.array([a + np.float32(q) * tp], np.float32)
        cands = (y0.view(np.int32) + np.arange(-64, 65, dtype=np.int32)).view(np.float32)
        out += list(cands[(cands - a) / tp == np.float32(q)][:1])
    return np.array(out, np.float32)


def vote_maps(dev, phase_scene, run, warps, seed=21):
    """Maps for the voting kernels, name -> (Phi, mask) on ``dev``: rows of
    299, 301 and 1281 floats (not a multiple of 16 bytes) with holed masks;
    at 1280x1024 (from numpy's generator): holes along every tile and warp
    edge of K4 at 1, 4 and 8 sweeps, the same map one float (and byte) off
    16-byte alignment, a checkerboard of values a float32 tie away from
    their neighbours, +-0 with +-2pi and denormals, and |Phi| ~ 1e6. K4's
    thread holds ``run`` rows, its block ``warps`` warps."""
    rng = np.random.default_rng(seed)
    maps = {}
    for H, W in ((215, 299), (215, 301), (1024, 1281)):
        _, Phi_n, _, mask, _ = phase_scene(H, W, W, H * W // 500, partial=True)
        maps[f"{W}x{H}"] = (Phi_n, mask)
    H, W = CAM_H, CAM_W
    _, Phi_n, _, mask, _ = phase_scene(H, W, 5, 400, partial=True)
    lines = np.zeros((H, W), bool)
    for h in (1, 4, 8):
        ow, oh = 30 * warps + 2 - 2 * h, run - 2 * h
        for bx in range(-(-W // ow)):
            c0 = bx * ow - h
            for c in [bx * ow, bx * ow - 1] + [c0 + 30 * wx + lane for wx in range(warps)
                                               for lane in (0, 1, 30, 31)]:
                if 0 <= c < W:
                    lines[:, c] = True
        for by in range(-(-H // oh)):
            lines[max(by * oh - 1, 0):by * oh + 1, :] = True
    holes = torch.from_numpy(lines & (rng.random((H, W)) < 0.5)).to(dev)
    maps["tile_warp_edge_holes"] = (Phi_n, mask & ~holes)
    off = [torch.empty(H * W + 1, dtype=t.dtype, device=dev) for t in maps["tile_warp_edge_holes"]]
    for b, t in zip(off, maps["tile_warp_edge_holes"]):
        b[1:] = t.reshape(-1)
    maps["offset1"] = tuple(b[1:].view(H, W) for b in off)
    even = (np.add.outer(np.arange(H), np.arange(W)) % 2) == 0
    ties = np.zeros((H, W), np.float32)
    for cols, a in ((slice(0, W // 2), 0.0), (slice(W // 2, W), 1.25)):
        ties[:, cols] = np.where(even[:, cols], np.float32(a),
                                 rng.choice(tie_values(a), size=(H, W // 2)))
    zeros = rng.choice(np.float32([0.0, -0.0, 2 * np.pi, -2 * np.pi, 4 * np.pi, 1e-40,
                                   -1e-40, np.pi]), size=(H, W))
    large = (np.where(np.arange(W) < W // 2, 1e6, -1e6)[None, :] + np.linspace(0, 60, W)[None, :]
             + 0.1 * rng.normal(size=(H, W)))
    large = np.where(rng.random((H, W)) < 0.01, large + 6 * np.pi, large)
    for name, Phi in (("ties", ties), ("zeros", zeros), ("large_1e6", large)):
        maps[name] = (torch.from_numpy(Phi.astype(np.float32)).to(dev),
                      torch.from_numpy(rng.random((H, W)) > 0.1).to(dev))
    return maps


def corner_fronts(H, W, run, warps, halo, seed=0):
    """(Phi, mask) numpy maps whose repair crosses K3's tile corners: a noisy
    ramp with an L of cells one fringe order off at every junction of four
    tiles (tiles of 30 warps + 2 - 2 halo by run - 2 halo owned cells). An
    arm of 2-5 cells ends in the diagonal tile and erodes a cell a sweep,
    so the cell at the L's bend (a tile's halo, beside the corner) repairs
    only once the corner cell in front of it has: with a halo of 2 or more,
    a tile that missed its diagonal neighbour's corner cells repairs its
    own cells below the bend a sweep late. The four orientations and arm
    lengths alternate over the junctions."""
    rng = np.random.default_rng(seed)
    ow, oh = 30 * warps + 2 - 2 * halo, run - 2 * halo
    bad = np.zeros((H, W), bool)
    i = 0
    for y0 in range(oh, H - 1, oh):
        for x0 in range(ow, W - 1, ow):
            o, a = i % 4, 2 + (i // 4) % 4
            row, col = (y0 - 1 if o < 2 else y0), (x0 if o % 2 == 0 else x0 - 1)
            arm = slice(max(col - a, 0), col + 1) if o % 2 == 0 else slice(col, col + a + 1)
            leg = slice(row, row + 9) if o < 2 else slice(max(row - 8, 0), row + 1)
            bad[row, arm] = True
            bad[leg, col] = True
            i += 1
    Phi = np.linspace(0, 40, W)[None, :] + 0.1 * rng.normal(size=(H, W))
    return np.where(bad, Phi + 2 * np.pi, Phi).astype(np.float32), np.ones((H, W), bool)


def cu_constant(source, name):
    """The integer constant ``name`` (a #define or a constexpr int) of
    slr_torch/kernels/csrc/<source>.cu: the kernels' geometry, read where
    it is set."""
    text = (Path(__file__).resolve().parent / "slr_torch" / "kernels" / "csrc"
            / f"{source}.cu").read_text()
    return int(re.search(rf"(?:#define {name}|constexpr int {name} =) (\d+)", text)[1])


def hdr_best_exposure(stacks, cfg, dec, saturation=0.98, bit_depth=None):
    """The exposure whose Gray frames K2 and its plain version decode at
    each pixel: the first of the largest scores, a score being the phase
    modulation B where the exposure is usable and -1 elsewhere. (H, W)
    int64, by ``argmax`` over all scores at once rather than the plain
    version's running best."""
    from slr_torch.kernels import fused_scan as fs
    E, _, H, W = stacks.shape
    c = fs._constants(cfg, dec, stacks.dtype, bit_depth, saturation)
    base = 2 + 2 * cfg.gray_bits + 2 * cfg.row_gray_bits
    scores = []
    for e in range(E):
        raw, rawf = fs._loaders(stacks[e])
        S, C = fs._phase_sums(rawf, base, c["sin_d"], c["cos_d"], (H, W), stacks.device)
        white = raw(0)
        usable = ((white - raw(1)) > c["tau_black"]) & (white < c["tau_sat"])
        scores.append(torch.where(usable, c["mod_scale"] * torch.sqrt(S * S + C * C), -1.0))
    return torch.argmax(torch.stack(scores), dim=0)


def box_exposures(best, exposures, box):
    """For each whole ``box`` (rows, columns) of a best-exposure map, the
    number of distinct exposures its pixels chose: for K2's staged box,
    (BOX_H, BOX_W) of csrc/fused_scan.cu; for (1, 32), the exposures whose
    Gray frames K2 stages for a warp. (H // rows, W // columns) int64."""
    (H, W), (h, w) = best.shape, box
    b = best[:H - H % h, :W - W % w].reshape(H // h, h, W // w, w)
    return sum((b == e).any(dim=3).any(dim=1).long() for e in range(exposures))


def k2_box():
    """K2's staged box, (rows, columns)."""
    return cu_constant("fused_scan", "BOX_H"), cu_constant("fused_scan", "BOX_W")


def k4_design_bytes(H, W, h, run, warps):
    """Bytes K4 moves in one launch of h sweeps on an (H, W) map: phi and the
    mask (5 B) of every loaded cell inside the map, each tile with its halo,
    and 4 B a pixel out."""
    ow, oh = 30 * warps + 2 - 2 * h, run - 2 * h

    def inside(n, step, width):
        return sum(min(b * step - h + width, n) - max(b * step - h, 0)
                   for b in range(-(-n // step)))

    return 5 * inside(W, ow, 30 * warps + 2) * inside(H, oh, run) + 4 * H * W


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


def render_orbit(dev, cam, proj, cfg, scans=None):
    """Config 5's orbit: ORBIT_SCANS_CONFIG5 uint8 scans of the rocks scene
    from a moving config-3 rig (its first ``scans``, if given). Returns
    (uint8 stacks, rig poses, truth points), on the card."""
    from slr_torch.geom.se3 import so3_exp
    from slr_torch.synth.render import move_rig, quantize_frames, render_scan
    from slr_torch.synth.scene import rocks_scene

    cam_d, proj_d = cam.to(dev), proj.to(dev)
    poses, stacks, truths = [], [], []
    for s in range(ORBIT_SCANS_CONFIG5 if scans is None else scans):
        R_m = so3_exp(torch.tensor([0.0, 0.025 * s, 0.008 * s], device=dev))
        t_m = torch.tensor([7.0 * s, -3.0 * s, 0.0], device=dev)
        cam_s, proj_s = move_rig(cam_d, proj_d, R_m, t_m)
        sc = render_scan(cam_s, proj_s, rocks_scene(cam_s, CAM_H, CAM_W), cfg,
                         noise_std=0.003,
                         generator=torch.Generator(device=dev).manual_seed(40 + s))
        stacks.append(quantize_frames(sc.frames))
        poses.append((R_m, t_m))
        truths.append(sc.points_true)
    return stacks, poses, truths


def registration_phases(dev, cam, proj, cfg, counts_of, card, pg_ptxas, icp_ptxas):
    """Phases 19-23, configs 4 and 5: K8 against its plain version, the
    exact search and a brute force at the reference's 256k size; the
    15-iteration band ICP (15 K8 launches); ICP between two dense config-3
    scans of the rocks scene (through K1, then K8); ``register_scans`` on a
    4-scan orbit (one pose-graph launch); config 5 on the 8-scan orbit
    (``config5_phase``), its OBJ text (``obj_text_phase``) and the pose
    graph (``pose_graph_phase``, ``pg_ptxas`` its build's registers) and the
    ICP (``icp_phase``, ``icp_ptxas``); then their times. Returns (config
    5's K1 launches, the 8-scan orbit as (uint8 stacks, rig poses, truth
    points), config 5's single-device result (``config5_phase``), the OBJ
    text kernel's, the pose-graph kernel's, the ICP kernel's and K8's
    entries of the ``kernels`` line)."""
    from slr_torch.config import RegistrationConfig
    from slr_torch.geom.se3 import so3_exp
    from slr_torch.kernels import band_nn as kb
    from slr_torch.pipeline import registerfuse as rf
    from slr_torch.pipeline.reconstruct import DenseReconstructor
    from slr_torch.registration.band import build_band_target
    from slr_torch.registration.icp import _resolve_nn_method, icp_point_to_plane
    from slr_torch.registration.nn import nearest_neighbors

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
    check(_resolve_nn_method("auto", N_BIG, N_BIG, dev) == "band", "auto is not band at 256k")

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

    # phase 20b: the same case on the voxel route (the reference's CPU
    # route, plain torch on the card: no kernel), twice, to the same bits
    def voxel_icp():
        return icp_point_to_plane(tgt, tgt_icp, n_icp, iters=ICP_BAND_ITERS,
                                  max_corr_dist=R_CORR, nn_method="voxel")

    resv, n = counts_of(voxel_icp)
    check(quiet(n), f"icp_voxel_256k: launches {n}")
    resv2 = voxel_icp()
    same = all(torch.equal(a, b) for a, b in zip(resv, resv2))
    check(same, "icp_voxel_256k: two calls differ")
    rv_err = float((resv.R - R_true).abs().max())
    tv_err = float((resv.t - t_true).abs().max())
    check(rv_err <= ICP_R_GATE and tv_err <= ICP_T_GATE,
          f"icp_voxel_256k: R_err {rv_err}, t_err {tv_err} mm")
    emit("icp_voxel_256k", iters=ICP_BAND_ITERS, R_err=rv_err, t_err_mm=tv_err,
         R_gate=ICP_R_GATE, t_gate_mm=ICP_T_GATE, bit_identical_calls=same,
         rms_mm=float(resv.rms), inlier_frac=float(resv.inlier_frac),
         ms=statistics.median(cuda_ms(voxel_icp, runs=3, warmup=0)))

    # the orbit: ORBIT_SCANS_CONFIG5 uint8 scans of the rocks scene from a
    # moving config-3 rig, decoded by K1 with the rig's own calibration, so
    # registration has to recover each rig pose; config 4 takes the first
    # ORBIT_SCANS
    cam_d = cam.to(dev)
    stacks, poses, truths = render_orbit(dev, cam, proj, cfg)
    model = DenseReconstructor(cam, proj, cfg).to(dev)

    def decode():
        return [model(f) for f in stacks[:ORBIT_SCANS]]

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
    # the ICP kernel once a fine alignment on each route: the 3 chain edges
    # and their feature races (6), the 2 closures, each raced where it did
    # not lock (2 to 4)
    check(n["pose_graph"] == 1 and n["icp"] == n["icp_polish"] and 8 <= n["icp"] <= 10
          and quiet(n, "pose_graph", "icp", "icp_polish"), f"config4_register: launches {n}")
    pg_launches = n["pose_graph"]
    icp_launches = {k: n[k] for k in ("icp", "icp_polish")}
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

    # phase 22b: config 5 on the 8-scan orbit
    mesh_dir = tempfile.TemporaryDirectory()
    n5, config5, config5_one = config5_phase(
        cam_d, proj.to(dev), cfg, stacks, poses, truths, counts_of, quiet,
        Path(mesh_dir.name) / "config5_mesh.obj")
    obj_entry = obj_text_phase(*config5_one["surface"], Path(mesh_dir.name) / "config5_mesh.obj",
                               main_launches=n5["obj_text"])
    pg_entry = pose_graph_phase(dev, pg_ptxas, main_launches=pg_launches + n5["pose_graph"])
    icp_entry = icp_phase(dev, config5_one["clouds"], cam_d, icp_ptxas,
                          {k: v + n5[k] for k, v in icp_launches.items()})

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
            "config4_e2e": (lambda: register(decode()), 3, 1),
            "config5_e2e": (config5, 3, 0)}
    turns = [("plain_k8", "k8", "exact_nn", "exact_nn", "k8", "plain_k8"),
             ("icp_band_256k", "icp_dense_scans", "icp_dense_scans", "icp_band_256k"),
             ("config4_e2e", "config5_e2e", "config4_e2e")]
    times = {k: [] for k in runs}
    for turn in turns:
        for name in turn:
            fn, n_runs, warmup = runs[name]
            times[name] += cuda_ms(fn, n_runs, warmup)
    mesh_dir.cleanup()
    times["k8"] = [t / K8_BATCH for t in times["k8"]]
    ms = {k: statistics.median(v) for k, v in times.items()}
    pairs = k8["256k"]["pairs"]
    emit("timing_registration", card=card, **{f"{k}_ms": v for k, v in ms.items()},
         **{f"{k}_ms_spread": [min(v), max(v)] for k, v in times.items()},
         runs_each={k: len(v) for k, v in times.items()}, k8_pairs=pairs,
         k8_pairs_per_s=pairs / (ms["k8"] * 1e-3),
         k8_fp32_issue_share=bound(instr=pairs * K8_INSTR_PER_PAIR)["bound_ms"] / ms["k8"],
         exact_pairs_per_s=N_BIG * N_BIG / (ms["exact_nn"] * 1e-3),
         after=nvidia_smi("clocks.sm,power.draw,temperature.gpu"))
    return n5["k1"], (stacks, poses, truths), config5_one, obj_entry, pg_entry, icp_entry, {
            "name": "band_nn_sorted", "route": "cuda",
            "source": "slr_torch/kernels/csrc/band_nn.cu",
            "replaces": "slr/registration/band.py:121",
            "launches": launches,
            "max_abs_err": max(v["d2_max_abs_err_vs_plain"] for v in k8.values()),
            "max_abs_err_of": "d2 (mm^2) against the plain version; points, normals "
                              "and idx equal",
            "ms": ms["k8"], "plain_ms": ms["plain_k8"], "exact_nn_ms": ms["exact_nn"],
            **bound(instr=pairs * K8_INSTR_PER_PAIR),
            "library_ms": None}


def config5_accuracy(name, reg, pts, val, verts, n_faces, clouds, poses, truths):
    """Config 5's accuracy gates on one run's output: the reference's ok
    rule (every pose within 0.5 deg and 2 mm, the fused cloud below 2.5 mm
    RMS over its first C5_RMS_POINTS points against the union of the truth
    clouds, valid where decoded; more than 1000 faces), BA's rms below 1.5,
    the port's tighter gates (poses within 0.5 mm, the fused cloud within
    0.25 mm) and the mesh's vertices within one voxel edge RMS of the truth
    union. Returns the measured numbers."""
    from slr_torch.registration.nn import nearest_neighbors

    errs = [pose_error(reg.R[s], reg.t[s], *poses[s]) for s in range(len(poses))]
    max_rot, max_t = max(e[0] for e in errs), max(e[1] for e in errs)
    check(max_rot < ROT_GATE_DEG and max_t < T_GATE_MM, f"{name}: {max_rot} deg, {max_t} mm")
    check(max_t <= C5_T_TIGHT_MM, f"{name}: translation error {max_t} mm > {C5_T_TIGHT_MM}")
    ba_rms = float(reg.pg_rms)
    check(ba_rms < C5_BA_RMS_GATE, f"{name}: BA rms {ba_rms}")
    gt = torch.cat([t.reshape(-1, 3) for t in truths])
    gt_valid = torch.cat([c.mask.reshape(-1) for c in clouds])
    check(tuple(pts.shape) == (C5_CAPACITY, 3) and bool(torch.isfinite(pts[val]).all()),
          f"{name}: fused points")
    sel = torch.nonzero(val)[:C5_RMS_POINTS, 0]
    _, d2 = nearest_neighbors(pts[sel], gt, gt_valid, tile=4096)
    fused_rms = float(torch.sqrt(torch.mean(d2)))
    check(fused_rms < C5_FUSED_GATE_MM and fused_rms <= C5_FUSED_TIGHT_MM,
          f"{name}: fused RMS {fused_rms} mm")
    check(n_faces > C5_MIN_FACES and bool(torch.isfinite(verts).all()),
          f"{name}: mesh of {n_faces} faces")
    stride = max(1, verts.shape[0] // C5_RMS_POINTS)
    mesh_sel = verts[::stride][:C5_RMS_POINTS]
    _, d2m = nearest_neighbors(mesh_sel, gt, gt_valid, tile=4096)
    mesh_rms = float(torch.sqrt(torch.mean(d2m)))
    check(mesh_rms <= C5_MESH_GATE_MM, f"{name}: mesh RMS {mesh_rms} mm")
    return dict(rot_err_deg=[e[0] for e in errs], t_err_mm=[e[1] for e in errs],
                max_rot_err_deg=max_rot, max_t_err_mm=max_t, ba_rms=ba_rms,
                fused_rms_mm=fused_rms, fused_rms_points=int(sel.numel()),
                fused_valid=int(val.sum()), mesh_faces=n_faces,
                mesh_verts=int(verts.shape[0]), mesh_rms_mm=mesh_rms,
                mesh_rms_points=int(mesh_sel.shape[0]))


def config5_run(stacks, cam, proj, cfg, mesh=None, stages=None, mesh_path=None):
    """Config 5 on the orbit, once: ``batched_reconstruct`` (one K1 launch a
    scan), ``register_scans_batched``, ``ba_refine``, ``fuse_scans``,
    ``fuse_tsdf``, ``extract_mesh`` and, given ``mesh_path``, the OBJ
    writer; with a ``mesh`` the batch, the registration's edges and the
    BA's landmarks over its map blocks. ``stages`` receives each stage's
    host wall (ms, the card synchronised at each end). Returns (clouds, reg,
    fused, volume, surface, the writer's counts or None, the TSDF's
    warnings)."""
    import warnings

    from slr_torch.config import RegistrationConfig
    from slr_torch.dist import batched_reconstruct
    from slr_torch.pipeline import registerfuse as rf
    from slr_torch.pipeline import tsdf
    from slr_torch.pipeline.reconstruct import ScanCloud

    stages = {} if stages is None else stages
    mark = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = (now - mark[0]) * 1e3
        mark[0] = now

    torch.cuda.synchronize()
    mark[0] = time.perf_counter()
    batch = batched_reconstruct(torch.stack(list(stacks)), cam, proj, cfg, mesh=mesh)
    clouds = [ScanCloud(*(x[i] for x in batch)) for i in range(len(stacks))]
    lap("batched_reconstruct")
    reg = rf.register_scans_batched(clouds, RegistrationConfig(icp_sample_points=C5_SAMPLES),
                                    use_features=True, cam=cam, mesh=mesh)
    lap("register_scans_batched")
    reg = rf.ba_refine(clouds, reg, n_landmarks=C5_LANDMARKS, iters=C5_BA_ITERS, mesh=mesh)
    lap("ba_refine")
    fused = rf.fuse_scans(clouds, reg, RegistrationConfig(voxel_size=C5_VOXEL),
                          capacity=C5_CAPACITY)
    lap("fuse_scans")
    with warnings.catch_warnings(record=True) as grown:
        warnings.simplefilter("always")
        vol = tsdf.fuse_tsdf(clouds, cam, reg.R, reg.t, size_vox=C5_TSDF, voxel=C5_VOXEL)
    lap("fuse_tsdf")
    surface = tsdf.extract_mesh(vol, with_colors=True)
    lap("extract_mesh")
    written = None
    if mesh_path is not None:
        written = tsdf.write_tsdf_mesh_obj(mesh_path, vol)
        lap("write_tsdf_mesh_obj")
    return clouds, reg, fused, vol, surface, written, [str(w.message) for w in grown]


def fstring_obj_lines(verts, cols, faces) -> bytes:
    """The OBJ writer's lines as the port formatted them in Python before
    the formatter kernel (``.tolist()``, then f-strings): the spec the
    kernel's bytes are held to."""
    v = verts.tolist()
    if cols is not None:
        lines = [f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c:.4f} {c:.4f} {c:.4f}\n"
                 for p, c in zip(v, cols.tolist())]
    else:
        lines = [f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n" for p in v]
    lines += [f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces.tolist()]
    return "".join(lines).encode()


def obj_domain_edge(k):
    """(the largest float32 inside the OBJ formatter's domain |x| * 10^k <
    2^63, the smallest beyond it); both are whole numbers at this size."""
    c = np.float32(2.0 ** 63 / 10 ** k)
    if int(c) * 10 ** k < 2 ** 63:
        return c, np.nextafter(c, np.float32(np.inf))
    return np.nextafter(c, np.float32(0)), c


def _f32(*xs):
    return np.array(xs, np.float32)


(OBJ_LIMIT6, OBJ_BEYOND6), (OBJ_LIMIT4, OBJ_BEYOND4) = obj_domain_edge(6), obj_domain_edge(4)
# the edges of the OBJ formatter's arithmetic, by kind
OBJ_EDGES = {
    "signed_zeros": _f32(0.0, -0.0),
    "tiny_negatives": _f32(-1e-7, -4.9999e-7, -5e-7, -1e-30, -1e-5),
    "ties_7th_decimal": _f32(1 / 128, 3 / 128, -1 / 128, 1 / 2 ** 20, 5 / 2 ** 20, 0.5, 2.5),
    "ties_5th_decimal": _f32(1 / 32, 3 / 32, -1 / 32, 1 / 2 ** 14, 0.125, 0.375),
    "carries": _f32(0.99999994, -0.99999994, 9.9999995, 99.99999, 999.99994, 0.99995,
                    9.99995, -0.99995),
    "subnormals": _f32(1e-45, -1e-45, 1e-40, -1.1754942e-38, 1.1754944e-38),
    "largest_in_domain": _f32(OBJ_LIMIT6, -OBJ_LIMIT6, 16777216.0, 3.4e9, -1.0e12),
    "nan_and_infinities": np.array([np.nan, -np.nan, np.inf, -np.inf], np.float32),
    "mm_coordinates": _f32(-123.456789, 480.0001, 1e-3, 2.675, 1.0000001, 65504.0),
}
# face tables: the smallest index, indices up to 2^31 - 2, and negative ones
OBJ_EDGE_FACES = [
    [[0, 1, 2]],
    [[2 ** 31 - 2, 2 ** 31 - 3, 0], [9, 99, 999], [123456789, 7, 2 ** 30]],
    [[-1, -2, -(2 ** 31)], [2 ** 31 - 1, 0, 10 ** 9]],
]


# ---- the pose graph (slr_torch.kernels.pose_graph) ---------------------------

def pose_graph_chain(S):
    """Config 5's edges on S scans: the chain (s - 1, s), then the closures
    (0, S - 1) and (i, i + 2) for even i that the chain lacks."""
    chain = [(s - 1, s) for s in range(1, S)]
    return chain + [p for p in [(0, S - 1)] + [(i, i + 2) for i in range(0, S - 2, 2)]
                    if p not in chain]


def pose_graph_edges(S, E):
    """Config 5's edges on S scans, then (i, i + k) for k = 3, 4, ... and
    every i, until there are E."""
    edges = pose_graph_chain(S)
    k = 3
    while len(edges) < E:
        edges += [(i, i + k) for i in range(S - k)][:E - len(edges)]
        k += 1
    return edges


# name: graph = pose_graph_case's (S, edges, seed, rotation noise rad,
# translation noise mm, step mm, initial error (rad, mm)), solve = the
# keywords of pose_graph_optimize
POSE_GRAPH_CASES = {
    # a tree's optimum has zero residual and its initial poses, chained from
    # the measurements, lie on it: they start 0.3 rad and 30 mm off, and stop
    # after 2 iterations, before the RMS (0.2 there) falls to float32 rounding
    "config5_chain": dict(graph=(8, pose_graph_chain(8)[:7], 5, 0.002, 0.05, 20.0, (0.3, 30.0)),
                          solve=dict(iters=2)),
    "config5_closures": dict(graph=(8, pose_graph_chain(8), 5, 0.002, 0.05, 20.0),
                             solve=dict(iters=20)),
    # one undamped step solves one edge exactly: damping 1 halves the
    # translation's steps, so the RMS after 5 is well above rounding
    "two_poses": dict(graph=(2, [(0, 1)], 5, 0.002, 0.05, 20.0, (0.3, 30.0)),
                      solve=dict(iters=5, damping=1.0)),
    "poses_32": dict(graph=(32, pose_graph_chain(32), 5, 0.002, 0.05, 20.0),
                     solve=dict(iters=20)),
    # closures between chain edges, one of them reversed (7, 0)
    "closure_out_of_order": dict(
        graph=(8, [(0, 1), (1, 2), (0, 2), (2, 3), (3, 4), (7, 0), (4, 5), (5, 6), (6, 7),
                   (4, 6)], 5, 0.002, 0.05, 20.0),
        solve=dict(iters=20)),
    # measured rotations exact and steps of 2 mm: every final rotation
    # residual lies in so3_log's Taylor branch (|w|^2 < 1e-12)
    "taylor_branch": dict(graph=(6, pose_graph_chain(6), 7, 0.0, 0.01, 2.0),
                          solve=dict(iters=20)),
    # past shared memory: the kernel's workspace in global memory
    "poses_48": dict(graph=(48, pose_graph_chain(48), 5, 0.002, 0.05, 20.0),
                     solve=dict(iters=20)),
}
POSE_GRAPH_TOL = dict(R=1e-5, t=1e-3, rms_rtol=1e-3)  # tests/test_torch_registration.py


def pose_graph_case(device, S, edges, seed, rot_noise, t_noise, step, init=(0.0, 0.0)):
    """A pose graph from numpy seeded ``seed``: S poses, each a random step
    (rotation within 0.2 rad, translation within ``step`` mm) from the last;
    each edge's measurement the true relative pose with N(0, ``rot_noise``)
    rad and N(0, ``t_noise``) mm of noise; the initial poses chained from
    the measurements of the edges (s - 1, s), then each but pose 0 moved by
    N(0, ``init``) (rad, mm). Returns (R0, t0, edges_i, edges_j, Z_R, Z_t)
    on ``device``, float32 and int64."""
    from slr_torch.geom.se3 import so3_exp

    def rot(v):
        return so3_exp(torch.from_numpy(v)).numpy()

    rng = np.random.default_rng(seed)
    Rt, tt = [np.eye(3)], [np.zeros(3)]
    for _ in range(1, S):
        Rr, tr = rot(rng.uniform(-0.2, 0.2, 3)), rng.uniform(-step, step, 3)
        Rt.append(Rt[-1] @ Rr)
        tt.append(Rt[-2] @ tr + tt[-1])
    Zr, Zt = [], []
    for i, j in edges:
        noise = rot(rng.normal(0, rot_noise, 3)) if rot_noise else np.eye(3)
        Zr.append(Rt[i].T @ Rt[j] @ noise)
        Zt.append(Rt[i].T @ (tt[j] - tt[i]) + rng.normal(0, t_noise, 3))
    R0, t0 = [np.eye(3)], [np.zeros(3)]
    for s in range(1, S):
        k = edges.index((s - 1, s))
        R0.append(R0[-1] @ Zr[k])
        t0.append(R0[-2] @ Zt[k] + t0[-1])
    if init[0] or init[1]:
        for s in range(1, S):
            R0[s] = R0[s] @ rot(rng.normal(0, init[0], 3))
            t0[s] = t0[s] + rng.normal(0, init[1], 3)

    def dev32(a):
        return torch.from_numpy(np.stack(a).astype(np.float32)).to(device)

    return (dev32(R0), dev32(t0), torch.tensor([e[0] for e in edges], device=device),
            torch.tensor([e[1] for e in edges], device=device), dev32(Zr), dev32(Zt))


def pose_graph_agreement(k, p):
    """The kernel's result ``k`` against the plain version's ``p``: max
    |dR|, max |dt| mm, the RMS's relative difference, and whether each is
    within POSE_GRAPH_TOL."""
    dR = float((k.R - p.R).abs().max())
    dt = float((k.t - p.t).abs().max())
    rk, rp = float(k.rms), float(p.rms)
    rel = abs(rk - rp) / max(abs(rp), 1e-30)
    tol = POSE_GRAPH_TOL
    ok = dR <= tol["R"] and dt <= tol["t"] and rel <= tol["rms_rtol"]
    return dict(R_max_abs_err=dR, t_max_abs_err_mm=dt, rms=rk, plain_rms=rp,
                rms_rel_err=rel, within=ok)


def pose_graph_max_w2(R, t, args):
    """The largest |w|^2 (w = vee(E - E^T), E the rotation of an edge's
    residual Z^-1 T_i^-1 T_j) over the edges of graph ``args`` at poses R,
    t: below 1e-12 so3_log takes its Taylor branch."""
    from slr_torch.geom.se3 import se3_compose, se3_inverse

    ei, ej = args[2], args[3]
    Rii, tii = se3_inverse(R[ei], t[ei])
    Er, _ = se3_compose(*se3_inverse(args[4], args[5]), *se3_compose(Rii, tii, R[ej], t[ej]))
    w = torch.stack([Er[:, 2, 1] - Er[:, 1, 2], Er[:, 0, 2] - Er[:, 2, 0],
                     Er[:, 1, 0] - Er[:, 0, 1]], -1)
    return float((w * w).sum(-1).max())


def pose_graph_flops(S, E):
    """A floor on one solve's operations an iteration (an FMA counted as 2):
    the Jacobian's 12E columns, each at least the residual's four 3x3
    products and four matrix-vector products in value and derivative
    (2 x 144 FMAs); J^T J on each edge's 12 x 12 block (78 entries of 6)
    and J^T r; the factorisation of the 6S x 6S matrix (n^3 / 3) and its
    two triangular solves (2 n^2)."""
    n = 6 * S
    return 12 * E * 576 + E * (78 + 12) * 12 + n ** 3 / 3 + 2 * n * n


# ---- ICP in one launch (slr_torch.kernels.icp) ------------------------------

# the kernel against its plain version, each tolerance keyed by the
# reading of icp_agreement it holds: the plain parity tests' tolerances near
# the origin (tests/test_torch_registration.py); and at scan coordinates,
# where the expanded form's rounding (~eps |q|^2) moves a nearest neighbour
# now and then, each route's limits on config 5's chain round at 10-40
# times the largest gap its seven edges read on an H100 (NN 3.4e-4 deg,
# 1.03e-3 mm, RMS 7.4e-3 relative, inlier_frac 5.5e-4; polish 1.3e-5 deg,
# 7.7e-5 mm, 4.5e-4, 6.0e-5; the NN's RMS 6.7x), tight enough that a
# missing reweighting, iteration or update shows
ICP_TOL = dict(R_max_abs_err=1e-5, t_max_abs_err_mm=1e-3, inlier_frac_abs_err=1e-3)
ICP_EDGE_TOL = dict(
    nn=dict(rot_deg=0.01, t_mm=0.02, rms_rel_err=0.05, inlier_frac_abs_err=5e-3),
    polish=dict(rot_deg=5e-4, t_mm=1e-3, rms_rel_err=5e-3, inlier_frac_abs_err=1e-3))
# the NN route's instructions a (query, target) pair in its search loop,
# read off cuobjdump -sass of the built libicp_*.so (icp_kernel<false>):
# the loop unrolled by 8 targets for 2 queries is 112 instructions for 16
# pairs: what the search needs, 6.5 a pair (48 FFMA, 16 FSETP, 16 FSEL, 16
# SEL, and 8 LDS.128, one target for two queries), and the loop's own 0.5
# (the index adds and the branch), which the bound leaves out; re-read them
# after changing the loop
ICP_INSTR_PER_PAIR = 6.5
ICP_LOOP_INSTR_PER_PAIR = 0.5


def rotation(rv):
    """so3_exp of a rotation vector, in float64 numpy (Rodrigues), as
    float32."""
    rv = np.asarray(rv, np.float64)
    th = np.linalg.norm(rv)
    K = np.array([[0, -rv[2], rv[1]], [rv[2], 0, -rv[0]], [-rv[1], rv[0], 0]]) / th
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def bumpy_surface(n, seed, half=100.0):
    """n points of the reference's bumpy surface z(x, y) over [-half,
    half]^2, near z = 0, and their unit normals; float32 numpy."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-half, half, (n, 2))
    z = 20 * np.sin(xy[:, 0] / 25.0) * np.cos(xy[:, 1] / 30.0) + 8 * np.sin(xy[:, 1] / 12.0)
    gx = 20 * np.cos(xy[:, 0] / 25.0) / 25.0 * np.cos(xy[:, 1] / 30.0)
    gy = (-20 * np.sin(xy[:, 0] / 25.0) * np.sin(xy[:, 1] / 30.0) / 30.0
          + 8 * np.cos(xy[:, 1] / 12.0) / 12.0)
    n0 = np.column_stack([-gx, -gy, np.ones_like(gx)])
    n0 /= np.linalg.norm(n0, axis=1, keepdims=True)
    return np.column_stack([xy, z]).astype(np.float32), n0.astype(np.float32)


def icp_case(device, n, seed, masked=False):
    """The ICP parity case: n points of the bumpy surface near the origin,
    the target moved by a small pose plus 0.05 mm of noise (so the Huber
    weights are not set by rounding; near the origin the expanded form's
    rounding, ~eps |q|^2, rarely changes a nearest neighbour). ``masked``:
    5 % of each side masked and an initial pose. Returns the keyword
    arguments of ``icp_point_to_plane`` on ``device`` and (R_true,
    t_true)."""
    src, n0 = bumpy_surface(n, seed)
    R_true = rotation([0.01, -0.02, 0.015])
    t_true = np.array([3.0, -2.0, 4.0], np.float32)
    noise = np.random.default_rng(seed).normal(0, 0.05, src.shape)
    tgt = (src @ R_true.T + t_true + noise).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    kw = dict(src=dev(src), tgt=dev(tgt), tgt_normals=dev((n0 @ R_true.T).astype(np.float32)))
    if masked:
        rng = np.random.default_rng(3)
        kw.update(tgt_valid=dev(rng.random(n) > 0.05), src_valid=dev(rng.random(n) > 0.05),
                  R0=dev(rotation([0.005, -0.01, 0.01])),
                  t0=dev(np.array([2.0, -1.0, 3.0], np.float32)))
    return kw, (R_true, t_true)


def icp_grid_case(device, seed=0):
    """The projective parity case: a 48 x 64 organized grid of a bumpy
    surface at ~500 mm, 3 rows masked, its normals, a 70 px camera, and 800
    source points drawn from it and seen from a moved rig. Returns the
    positional arguments of ``icp_projective`` (src, src_valid, grid, mask,
    normals, camera) and the rig's move (R_true, t_true)."""
    from slr_torch.geom.camera import make_camera
    from slr_torch.registration.normals import grid_normals

    H, W = 48, 64
    cam = make_camera(fx=70.0, fy=70.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, device=device)
    v, u = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                       indexing="ij")
    x, y = (u - W / 2 + 0.5) / 70.0, (v - H / 2 + 0.5) / 70.0
    z = 500 + 25 * np.sin(x * 4) * np.cos(y * 5) + 10 * x
    grid = np.stack([x * z, y * z, z], -1).astype(np.float32)
    mask = np.ones((H, W), bool)
    mask[:3] = False
    R_m, t_m = rotation([0.004, -0.006, 0.003]), np.array([1.0, -0.8, 1.5], np.float32)
    sel = np.random.default_rng(seed).choice(H * W, 800, replace=False)
    src = ((grid.reshape(-1, 3)[sel] - t_m) @ R_m).astype(np.float32)
    g, m = torch.from_numpy(grid).to(device), torch.from_numpy(mask).to(device)
    return ((torch.from_numpy(src).to(device),
             torch.from_numpy(mask.reshape(-1)[sel]).to(device), g, m, grid_normals(g, m), cam),
            (R_m, t_m))


def icp_agreement(k, p, tol):
    """ICP result ``k`` (the kernel's) against ``p`` (the plain version's):
    max |dR|, max |dt| mm, |d inlier_frac|, the RMS's relative difference,
    the rotation angle (deg) and translation (mm) between the two poses,
    and whether each reading that ``tol`` names is within it."""
    dR = float((k.R - p.R).abs().max())
    dt = float((k.t - p.t).abs().max())
    di = float((k.inlier_frac - p.inlier_frac).abs().max())
    rk, rp = k.rms.double(), p.rms.double()
    rel = float(((rk - rp).abs() / rp.abs().clamp(min=1e-30)).max())
    rot, tr = zip(*(pose_error(a, b, c, d) for a, b, c, d in
                    zip(k.R.reshape(-1, 3, 3), k.t.reshape(-1, 3), p.R.reshape(-1, 3, 3),
                        p.t.reshape(-1, 3))))
    got = dict(R_max_abs_err=dR, t_max_abs_err_mm=dt, inlier_frac_abs_err=di, rms_rel_err=rel,
               rot_deg=max(rot), t_mm=max(tr))
    return dict(got, within=all(got[name] <= lim for name, lim in tol.items()))


def obj_edge_case(device):
    """(verts, cols, faces) of every value of ``OBJ_EDGES`` in each column,
    the colours the same values after the largest inside the colours'
    domain (10^4), and every face of ``OBJ_EDGE_FACES``."""
    x = np.concatenate(list(OBJ_EDGES.values()))
    verts = np.stack([x, np.roll(x, 1), np.roll(x, 2)], 1)
    cols = np.concatenate([[OBJ_LIMIT4, -OBJ_LIMIT4], x[:-2]]).astype(np.float32)
    faces = np.array(sum(OBJ_EDGE_FACES, []), np.int32)
    return (torch.from_numpy(np.ascontiguousarray(verts)).to(device),
            torch.from_numpy(cols).to(device), torch.from_numpy(faces).to(device))


def obj_text_phase(verts, faces, cols, mesh_path=None, main_launches=0):
    """Phase 22c, ``obj_text_vs_plain``: the OBJ text formatter
    (``slr_torch.kernels.obj_text``, two launches a text) on config 5's
    mesh, with and without colours, and on ``obj_edge_case``: its bytes
    equal to its plain version's on the CPU (gated), config 5's also to
    Python's f-strings (the writer before the kernel) and, given
    ``mesh_path``, the writer's file to the header and those bytes (gated);
    ``launches.obj_text`` 2 a text (gated); a position past the domain
    refused with ``ValueError`` (gated). Then times at config 5's shapes:
    each kernel's device time (CUDA-graph replay), the wrapper (both
    launches and both reads, host wall), the text's read into page-locked
    and into pageable memory (in turns), the plain version and the
    f-strings. Returns the kernel's entry of the ``kernels`` line, its
    launches the main path's (``main_launches``: config 5's writer); this
    phase's own are its gate."""
    from slr_torch import observability as ob
    from slr_torch.kernels import obj_text as ot

    def n_launches():
        return ob.snapshot().counts.get("launches.obj_text", 0)

    dev = verts.device
    cols = torch.clamp(cols, 0.0, 1.0)
    cases = {"config5": (verts, cols, faces), "config5_no_colors": (verts, None, faces),
             "edges": obj_edge_case(dev)}
    texts, agree = {}, {}
    for name, case in cases.items():
        before = n_launches()
        got = ot.format_obj(*case)
        launched = n_launches() - before
        plain = ot.format_obj(*(None if t is None else t.cpu() for t in case))
        same = torch.equal(got, plain)
        check(same and launched == 2, f"obj_text {name}: bit_equal {same}, launches {launched}")
        texts[name] = got
        agree[name] = dict(lines=sum(int(t.shape[0]) for t in case[::2]),
                           bytes=int(got.shape[0]), launches=launched, bit_equal=same)
    spec = fstring_obj_lines(verts, cols, faces)
    check(texts["config5"].numpy().tobytes() == spec, "obj_text: config 5 differs from f-strings")
    file_same = None
    if mesh_path is not None:
        file_same = Path(mesh_path).read_bytes() == OBJ_HEADER + spec
        check(file_same, "obj_text: the writer's file differs from the f-string writer's")
    try:
        ot.format_obj(torch.tensor([[1e13, 0.0, 0.0]], device=dev), None, faces[:0])
        refused = False
    except ValueError:
        refused = True
    check(refused, "obj_text: 1e13 mm formatted, not refused")
    # times at config 5's shapes
    v, c, f = cases["config5"]
    ends = ot.line_ends(v, c, f)
    n_bytes = ot.text_length(ends)
    text = ot.write_text(v, c, f, ends, n_bytes)
    lens = torch.zeros_like(ends)
    device_ms = {
        "lengths": statistics.median(graph_ms(
            lambda: ot._launch("slr_obj_lengths", "length", v, c, f, lens))),
        "write": statistics.median(graph_ms(
            lambda: ot._launch("slr_obj_write", "write", v, c, f, ends, text)))}
    reads = {"pinned": [], "pageable": []}
    for name in ("pinned", "pageable", "pageable", "pinned"):
        fn = (lambda: ot.to_host(text)) if name == "pinned" else text.cpu
        fn()
        reads[name] += [host_ms(fn, 10)]
    cpu = [t.cpu() for t in (v, c, f)]
    ms = {"wrapper": host_ms(lambda: ot.format_obj(v, c, f)),
          "plain": host_ms(lambda: ot.format_obj(*cpu), 3),
          "fstrings": host_ms(lambda: fstring_obj_lines(v, c, f), 3),
          **{f"read_{k}": statistics.median(t) for k, t in reads.items()}}
    # the digits the write pass computes, a floor on its operations: a
    # vertex's colour once (it is copied twice); each a step of the 32-bit
    # loop (no integer part here passes 2^32)
    def n_digits(text):
        host = text.numpy()
        return int(((host >= 48) & (host <= 57)).sum())

    plain_digits = n_digits(texts["config5_no_colors"])
    digits = plain_digits + (n_digits(texts["config5"]) - plain_digits) // 3
    moved = 16 * v.shape[0] + 12 * f.shape[0] + n_bytes   # inputs read once, text written
    bound_ms = {"bytes": bound(moved)["bound_ms"],
                "operations": digits * OBJ_DIGIT_INSTR / INT32_ISSUE_PER_S * 1e3}
    emit("obj_text_vs_plain", cases=agree, fstring_equal=True, writer_file_equal=file_same,
         refused_outside_domain=refused, device_ms=device_ms,
         device_ms_total=sum(device_ms.values()), **{f"{k}_ms": x for k, x in ms.items()},
         read_ms_turns=reads, digits=digits, moved_bytes=moved, bound_ms=bound_ms,
         timing="device: CUDA-graph replay of 20 launches; the rest host wall from an "
                "idle card, medians")
    return {"name": "obj_text", "route": "cuda", "source": "slr_torch/kernels/csrc/obj_text.cu",
            "replaces": None, "launches": main_launches,
            "launches_phase": sum(a["launches"] for a in agree.values()),
            "max_abs_err": 0, "max_abs_err_of": "bytes against the plain version: equal",
            "ms": ms["wrapper"], "plain_ms": ms["plain"], "fstrings_ms": ms["fstrings"],
            "device_ms": sum(device_ms.values()),
            "bound_ms": max(bound_ms.values()), "bound_by": max(bound_ms, key=bound_ms.get),
            "library_ms": None}


def pose_graph_phase(dev, ptxas, main_launches=0):
    """Phase 22d, ``pose_graph_vs_plain``: the pose-graph kernel
    (``slr_torch.kernels.pose_graph``, one launch a solve) against its plain
    version on the card (``pose_graph_optimize_reference``) on every
    ``POSE_GRAPH_CASES`` graph, and on 32 poses with 207 edges (the most
    that shared memory holds) and 208 (the workspace): within
    POSE_GRAPH_TOL (gated), the taylor_branch case's final rotation
    residuals below so3_log's 1e-12 (gated), one launch a call and two
    calls the same bits (gated). Then times at config 5's graph (8 poses,
    11 edges): the kernel's device time (CUDA-graph replay), the wrapper's
    and the plain version's spans (CUDA events, host time included).
    Returns the kernel's entry of the ``kernels`` line, its launches the
    main path's (``main_launches``); this phase's own are its gate."""
    from slr_torch import observability as ob
    from slr_torch.kernels import pose_graph as kpg
    from slr_torch.registration import posegraph as pg

    def n_launches():
        return ob.snapshot().counts.get("launches.pose_graph", 0)

    cases = dict(POSE_GRAPH_CASES)
    for E in (207, 208):
        cases[f"poses_32_edges_{E}"] = dict(
            graph=(32, pose_graph_edges(32, E), 5, 0.002, 0.05, 20.0), solve=dict(iters=20))
    agree, launched = {}, 0
    for name, case in cases.items():
        args = pose_graph_case(dev, *case["graph"])
        S, E = args[0].shape[0], args[2].shape[0]
        before = n_launches()
        k = pg.pose_graph_optimize(*args, **case["solve"])
        k2 = pg.pose_graph_optimize(*args, **case["solve"])
        torch.cuda.synchronize()
        n = n_launches() - before
        launched += n
        same = all(torch.equal(a, b) for a, b in zip(k, k2))
        p = pg.pose_graph_optimize_reference(*args, **case["solve"])
        a = pose_graph_agreement(k, p)
        a.update(poses=S, edges=E, in_shared=kpg.in_shared(S, E), launches=n,
                 bit_identical_calls=same, max_w2=pose_graph_max_w2(k.R, k.t, args),
                 **case["solve"])
        check(a["within"] and n == 2 and same, f"pose_graph {name}: {a}")
        check(name != "taylor_branch" or a["max_w2"] < 1e-12, f"pose_graph {name}: {a}")
        agree[name] = a
    shared = [agree[k]["in_shared"]
              for k in ("poses_32_edges_207", "poses_32_edges_208", "poses_48")]
    check(shared == [True, False, False], f"pose_graph: in shared memory {shared}")
    # times at config 5's graph
    args = pose_graph_case(dev, *POSE_GRAPH_CASES["config5_closures"]["graph"])
    S, E = args[0].shape[0], args[2].shape[0]
    device_ms = statistics.median(graph_ms(lambda: kpg.solve(*args, 20, 1e-6, 300.0)))
    args48 = pose_graph_case(dev, *POSE_GRAPH_CASES["poses_48"]["graph"])
    device_ms_48 = statistics.median(graph_ms(lambda: kpg.solve(*args48, 20, 1e-6, 300.0),
                                              launches=10))
    ms = {"wrapper": statistics.median(cuda_ms(lambda: pg.pose_graph_optimize(*args))),
          "plain": statistics.median(cuda_ms(lambda: pg.pose_graph_optimize_reference(*args),
                                             runs=5, warmup=1))}
    flops = 20 * pose_graph_flops(S, E)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bound_ms = bound(instr=flops / 2)["bound_ms"]
    regs = {k: v for k, v in ptxas.items() if "pose_graph" in k}
    emit("pose_graph_vs_plain", cases=agree, tolerances=POSE_GRAPH_TOL,
         config5_poses=S, config5_edges=E, device_ms=device_ms,
         device_ms_poses_48_workspace=device_ms_48,
         wrapper_ms=ms["wrapper"], plain_ms=ms["plain"], flops=flops, bound_ms=bound_ms,
         bound_ms_one_sm=bound_ms * sms, smem_bytes=4 * kpg.words(S, E), registers=regs,
         timing=f"device: CUDA-graph replay of {GRAPH_LAUNCHES} launches; wrapper and plain: "
                "CUDA events around one call, host time included, medians")
    return {"name": "pose_graph", "route": "cuda", "source": "slr_torch/kernels/csrc/pose_graph.cu",
            "replaces": None, "launches": main_launches, "launches_phase": launched,
            "max_abs_err": max(a["R_max_abs_err"] for a in agree.values()),
            "max_abs_err_of": "R against the plain version",
            "max_abs_err_t_mm": max(a["t_max_abs_err_mm"] for a in agree.values()),
            "ms": ms["wrapper"], "plain_ms": ms["plain"], "device_ms": device_ms,
            "bound_ms": bound_ms, "bound_by": "operations", "bound_ms_one_sm": bound_ms * sms,
            "library_ms": None}


def icp_phase(dev, clouds, cam, ptxas, main_launches):
    """Phase 22e, ``icp_vs_plain``: the ICP kernel (``slr_torch.kernels.icp``,
    one launch a round on each route) against its plain versions on the
    card, on config 5's chain round (the orbit's decoded clouds, 4096
    samples each as ``register_scans_batched`` draws them, the 7 chain
    edges from the identity, the defaults): each edge's NN route against
    ``icp_point_to_plane_reference`` (the exact search) and its polish
    against ``icp_projective_reference`` from the plain NN result, each
    within its route's ICP_EDGE_TOL (gated; with how far the plain polish
    moved its start, which the polish's limits must be well under to see
    a polish that does nothing); one launch a route, each edge of the batch the
    bits of its single call, two calls the same bits (gated). Then times:
    the kernel's device time at E = 7 and E = 4 on both routes (CUDA-graph
    replay), the wrapper's span and the eager round it replaces (``vmap``
    over the plain loops, CUDA events). Returns the kernel's entry of the
    ``kernels`` line, its launches the main path's (``main_launches``, by
    route); this phase's own are its gate."""
    from torch.func import vmap

    from slr_torch import observability as ob
    from slr_torch.config import RegistrationConfig
    from slr_torch.kernels import icp as kicp
    from slr_torch.pipeline import registerfuse as rf
    from slr_torch.registration import projective as rp
    from slr_torch.registration.icp import ICPResult, icp_point_to_plane_reference
    from slr_torch.registration.normals import grid_normals

    def n_launches():
        counts = ob.snapshot().counts
        return {k: counts.get(f"launches.{k}", 0) for k in ("icp", "icp_polish")}

    rc = RegistrationConfig(icp_sample_points=C5_SAMPLES)
    samples = [rf._subsample(c, rc.icp_sample_points, seed=i) for i, c in enumerate(clouds)]
    pts = torch.stack([p for p, _ in samples])
    nrm = torch.stack([n for _, n in samples])
    grids = (torch.stack([c.points for c in clouds]), torch.stack([c.mask for c in clouds]),
             torch.stack([grid_normals(c.points, c.mask) for c in clouds]))
    S = len(clouds)
    si, ti = torch.arange(1, S, device=dev), torch.arange(0, S - 1, device=dev)
    E, N = S - 1, pts.shape[1]
    nn_kw = dict(iters=rc.icp_iters, max_corr_dist=rc.icp_max_corr_dist)
    pol_kw = dict(iters=max(8, rc.icp_iters // 2), max_corr_dist=rc.icp_max_corr_dist)

    def round_of(E):
        res = ICPResult(*kicp.align(pts[si[:E]], pts[ti[:E]], nrm[ti[:E]], **nn_kw))
        return res, ICPResult(*kicp.polish(pts[si[:E]], None, *grids, ti[:E], cam, res.R,
                                           res.t, **pol_kw))

    before = n_launches()
    (nn, pol), (nn2, pol2) = round_of(E), round_of(E)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in n_launches().items()}
    same = all(torch.equal(a, b) for a, b in zip((*nn, *pol), (*nn2, *pol2)))
    check(launched == {"icp": 2, "icp_polish": 2} and same,
          f"icp_vs_plain: launches {launched}, two calls the same bits: {same}")
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    edges, single = [], True
    for e in range(E):
        s, t = int(si[e]), int(ti[e])
        want = icp_point_to_plane_reference(pts[s], pts[t], nrm[t], nn_method="exact", **nn_kw)
        want_p = rp.icp_projective_reference(pts[s], ones, grids[0][t], grids[1][t],
                                             grids[2][t], cam, R0=want.R, t0=want.t, **pol_kw)
        one = ICPResult(*(x[0] for x in kicp.align(pts[s:s + 1], pts[t:t + 1], nrm[t:t + 1],
                                                   **nn_kw)))
        one_p = rp.icp_projective(pts[s], ones, grids[0][t], grids[1][t], grids[2][t], cam,
                                  R0=one.R, t0=one.t, **pol_kw)
        single &= all(torch.equal(a[e], b) for a, b in zip((*nn, *pol), (*one, *one_p)))
        a = icp_agreement(ICPResult(*(x[e] for x in nn)), want, ICP_EDGE_TOL["nn"])
        b = icp_agreement(ICPResult(*(x[e] for x in pol)), want_p, ICP_EDGE_TOL["polish"])
        check(a["within"] and b["within"], f"icp_vs_plain edge {e}: {a} {b}")
        step = pose_error(want_p.R, want_p.t, want.R, want.t)
        edges.append(dict(edge=[s, t], nn=a, polish=b, rms_mm=float(pol.rms[e]),
                          plain_rms_mm=float(want_p.rms), inlier_frac=float(pol.inlier_frac[e]),
                          plain_polish_step_deg=step[0], plain_polish_step_mm=step[1]))
    check(single, "icp_vs_plain: a batch differs from single calls")
    device_ms, wrapper_ms = {}, {}
    for E_t in (E, 4):
        s, t = si[:E_t], ti[:E_t]
        device_ms[f"nn_E{E_t}"] = statistics.median(graph_ms(
            lambda: kicp.align(pts[s], pts[t], nrm[t], **nn_kw), launches=5))
        device_ms[f"polish_E{E_t}"] = statistics.median(graph_ms(
            lambda: kicp.polish(pts[s], None, *grids, t, cam, nn.R[:E_t], nn.t[:E_t],
                                **pol_kw), launches=5))
        wrapper_ms[f"nn_E{E_t}"] = statistics.median(cuda_ms(
            lambda: kicp.align(pts[s], pts[t], nrm[t], **nn_kw), runs=5))

    def plain_round():
        return vmap(lambda a, b, c: icp_point_to_plane_reference(
            a, b, c, nn_method="exact", **nn_kw))(pts[si], pts[ti], nrm[ti])

    plain_ms = statistics.median(cuda_ms(plain_round, runs=3, warmup=1))
    pairs = {E_t: E_t * N * N * rc.icp_iters for E_t in (E, 4)}
    bounds = {E_t: bound(instr=p * ICP_INSTR_PER_PAIR)["bound_ms"] for E_t, p in pairs.items()}
    regs = {k: v for k, v in ptxas.items() if "icp" in k}
    emit("icp_vs_plain", edges=edges, tolerances=ICP_EDGE_TOL, launches=launched,
         bit_identical_calls=same, batch_equals_single_calls=single, samples=N,
         device_ms=device_ms, wrapper_ms=wrapper_ms, plain_round_ms=plain_ms,
         pairs={f"E{k}": v for k, v in pairs.items()},
         instr_per_pair=ICP_INSTR_PER_PAIR, loop_instr_per_pair=ICP_LOOP_INSTR_PER_PAIR,
         bound_ms={f"E{k}": v for k, v in bounds.items()},
         smem_bytes=kicp.smem_bytes(N), registers=regs,
         timing=f"device: CUDA-graph replay of 5 launches; wrapper and plain: CUDA events "
                "around one call, host time included, medians")
    return {"name": "icp", "route": "cuda", "source": "slr_torch/kernels/csrc/icp.cu",
            "replaces": None, "launches": main_launches["icp"],
            "launches_polish": main_launches["icp_polish"],
            "launches_phase": sum(launched.values()),
            "max_rot_err_deg": max(max(x["nn"]["rot_deg"], x["polish"]["rot_deg"]) for x in edges),
            "max_t_err_mm": max(max(x["nn"]["t_mm"], x["polish"]["t_mm"]) for x in edges),
            "max_abs_err_of": "each edge's pose against the plain version's",
            "ms": wrapper_ms[f"nn_E{E}"], "plain_ms": plain_ms,
            "device_ms": device_ms[f"nn_E{E}"], "device_ms_polish": device_ms[f"polish_E{E}"],
            "bound_ms": bounds[E], "bound_by": "operations", "library_ms": None}


def config5_phase(cam, proj, cfg, stacks, poses, truths, counts_of, quiet, mesh_path):
    """Phase 22b, config 5 at the reference's size: ``config5_run`` on the
    ORBIT_SCANS_CONFIG5 uint8 scans (one K1 launch a scan, no other
    kernel), with the OBJ writer. Gated: the
    reference's ok rule (every pose within 0.5 deg and 2 mm, the fused cloud
    below 2.5 mm RMS over its first 8192 points against the union of the
    truth clouds, more than 1000 faces), BA's rms below 1.5, the port's own
    tighter gates (poses within 0.5 mm, the fused cloud within 0.25 mm), the
    mesh's vertices within one voxel edge RMS of the truth union, and the
    same bits in two calls; the counted run launches K1 once a scan, the
    OBJ text kernels twice, the pose-graph kernel once and each ICP route
    four times (the chain, its race, the closures, theirs), and nothing
    else. Returns (the counted run's
    launches of each kernel, a function running the pipeline once, for the timed turns, and the
    single-device result the parallel tier is held to: its clouds, poses
    and the second call's stage walls)."""
    def pipeline(stages):
        return config5_run(stacks, cam, proj, cfg, None, stages, mesh_path)

    stages1, stages2 = {}, {}
    out, n = counts_of(lambda: pipeline(stages1))
    check(n["k1"] == ORBIT_SCANS_CONFIG5 and n["obj_text"] == 2 and n["pose_graph"] == 1
          and n["icp"] == n["icp_polish"] == 4
          and quiet(n, "k1", "obj_text", "pose_graph", "icp", "icp_polish"),
          f"config5: launches {n}")
    clouds, reg, (pts, val, col, n_vox), vol, (verts, faces, cols), written, grown = out
    n_faces = int(faces.shape[0])
    check(written == (int(verts.shape[0]), n_faces), f"config5: mesh {written}")
    acc = config5_accuracy("config5", reg, pts, val, verts, n_faces, clouds, poses, truths)
    # the same bits in a second call
    again = pipeline(stages2)
    _, reg2, (pts2, val2, col2, n_vox2), vol2, (verts2, faces2, cols2), _, _ = again
    same = all(torch.equal(a, b) for a, b in (
        (reg.R, reg2.R), (reg.t, reg2.t), (pts, pts2), (val, val2), (col, col2),
        (n_vox, n_vox2), (vol.tsdf, vol2.tsdf), (vol.weight, vol2.weight),
        (vol.color, vol2.color), (verts, verts2), (faces, faces2), (cols, cols2)))
    check(same, "config5: two calls differ")
    emit("config5", scans=ORBIT_SCANS_CONFIG5, samples=C5_SAMPLES, landmarks=C5_LANDMARKS,
         ba_iters=C5_BA_ITERS, launches=n["k1"], obj_text_launches=n["obj_text"],
         bit_identical_calls=same, **acc,
         rot_gate_deg=ROT_GATE_DEG, t_gate_mm=T_GATE_MM, t_tight_gate_mm=C5_T_TIGHT_MM,
         icp_rms_mm=reg.icp_rms.tolist(), ba_rms_gate=C5_BA_RMS_GATE,
         n_voxels=int(n_vox), fused_gate_mm=C5_FUSED_GATE_MM,
         fused_tight_gate_mm=C5_FUSED_TIGHT_MM, tsdf_size_vox=list(C5_TSDF),
         tsdf_voxel_mm=float(vol.voxel), tsdf_origin=vol.origin.tolist(),
         tsdf_observed_voxels=int((vol.weight > 0).sum()), tsdf_warnings=grown,
         mesh_gate_mm=C5_MESH_GATE_MM, obj_bytes=mesh_path.stat().st_size,
         valid_px=[int(c.mask.sum()) for c in clouds],
         stage_ms_first=stages1, stage_ms=stages2,
         stage_timing="host wall, the card synchronised at each end of a stage")
    return n, lambda: pipeline({}), dict(clouds=clouds, reg=reg, stages=stages2,
                                         surface=(verts, faces, cols))


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


def long_range_pairs(device, R, U, N, K, seed=0):
    """(lo, hi, payload) of R rows of U pairs whose codes climb over the K
    bins with a wiggle of a few bins, so each bin's first..last pair range
    is long and holds many crossings; 5 % of the pairs invalid (lo == hi ==
    -1, zero payload)."""
    rng = np.random.default_rng(seed)
    lo = np.cumsum(rng.uniform(0, 2.0 * (K + 6) / U, (R, U)), axis=1) - 3.0
    lo = (lo + 2.0 * rng.normal(size=(R, U))).astype(np.float32)
    hi = (lo + rng.uniform(0.1, 2.4, (R, U))).astype(np.float32)
    dead = rng.random((R, U)) < 0.05
    lo[dead] = hi[dead] = -1.0
    pay = rng.normal(0, 3, (R, N, U)).astype(np.float32)
    pay[np.broadcast_to(dead[:, None, :], pay.shape)] = 0.0
    return [torch.from_numpy(a).to(device) for a in (lo, hi, pay)]


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
    from slr_torch.observability import HBM_GBPS, roofline
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
    # K6 on rows past one block (40,000 pairs at 1,024 bins): chunks of
    # pairs in order, each continuing the previous chunk's sums
    lo_c, hi_c, pay_c = long_range_pairs(dev, *K6_CHUNK_CASE)
    K_c = K6_CHUNK_CASE[3]
    ref_c = kx.crossing_bin_sum_reference(lo_c, hi_c, pay_c, K_c)
    out_c, n = counts_of(lambda: kx.crossing_bin_sum(lo_c, hi_c, pay_c, K_c))
    chunk = kx.bin_sum_chunk(K_c)
    check(n["k6"] == -(-lo_c.shape[1] // chunk) >= 2, f"K6 chunked: launches {n}")
    same = bool(torch.equal(out_c, ref_c))
    check(same, "K6 chunked: not bit-equal to its plain version")
    fires = kx.crossing_bin_sum_reference(lo_c, hi_c, torch.ones_like(pay_c[:, :1]), K_c)
    k6_chunked = dict(
        shape=[*pay_c.shape, K_c], chunk_pairs=chunk, chunks=n["k6"], bit_equal=same,
        max_fires=float(fires.max()), max_abs_err=float((out_c - ref_c).abs().max()),
        ms=statistics.median(cuda_ms(lambda: kx.crossing_bin_sum(lo_c, hi_c, pay_c, K_c))),
        plain_ms=statistics.median(cuda_ms(
            lambda: kx.crossing_bin_sum_reference(lo_c, hi_c, pay_c, K_c), 3, 1)),
        bytes=crossing_k6_bytes_needed(lo_c, hi_c, pay_c.shape[1], K_c))
    k6_chunked["bound_ms"] = bound(k6_chunked["bytes"])["bound_ms"]
    k6_checks["chunked_4x40000"] = k6_chunked
    del lo_c, hi_c, pay_c, ref_c, out_c, fires
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
    # ptxas reports only on a fresh build: a rerun in the same checkout
    # loads the library built before
    regs = {name: next((v for k, v in ptxas.items() if pattern in k),
                       "built before this run: not reported")
            for name, pattern in (("k7_merge_layout", "interp_fused_kernelILi4ELi3"),
                                  ("k7_any_layout", "interp_fused_kernelILi8"),
                                  ("k6", "bin_sum_kernelILb0"),
                                  ("k6_chunked", "bin_sum_kernelILb1"))}
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
         **{f"{k}_hbm_share": v / HBM_GBPS for k, v in gbs.items()},
         k7_pass_shapes=[[*a1[0].shape, a1[3]], [*a2[0].shape, a2[3]]],
         k6_pass1_shape=[R6, N6, U6, K6],
         device_ms=dev_ms, device_ms_spread={k: [min(v), max(v)] for k, v in device.items()},
         device_timing=f"CUDA graph of {GRAPH_LAUNCHES} launches, replayed in turns",
         device_hbm_share={k: roofline(moved[k], 0, dev_ms[k])["sol_fraction"]
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
        **bound(moved["k7_pass1"]),
        "library_ms": None,
        "ms_pass2": ms["k7_pass2"], "plain_ms_pass2": ms["plain_k7_pass2"],
        "bound_ms_pass2": bound(moved["k7_pass2"])["bound_ms"],
        "bound_ms_all_inputs": bound(moved_all["k7_pass1"])["bound_ms"],
        "bound_ms_all_inputs_pass2": bound(moved_all["k7_pass2"])["bound_ms"],
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
        **bound(moved["k6_5mp_pass1"]), "library_ms": ms["bmm_k6_5mp_pass1"],
        "library": "torch.bmm of the float32 payload with a prebuilt float32 one-hot",
        "ms_of": "CUDA events around one launch through the wrapper (host time included)",
        "bound_ms_all_inputs": bound(moved_all["k6_5mp_pass1"])["bound_ms"],
        "device_ms": dev_ms["k6_5mp_pass1"], "registers": regs["k6"],
        "grid_blocks_per_sm": shapes["k6_5mp_pass1"],
        "ms_chunked": k6_chunked["ms"], "plain_ms_chunked": k6_chunked["plain_ms"],
        "registers_chunked": regs["k6_chunked"],
        "bound_ms_chunked": k6_chunked["bound_ms"], "chunks": k6_chunked["chunks"],
        "chunked_shape": k6_chunked["shape"],
    }]


def calib_v24_case(dev):
    """benchmarks/tpu_matrix.py:616-646's inputs with the port's ``so3_exp``
    and ``project``: 24 views of a 9x6 board (20 mm) seen by a camera and a
    projector 180 mm aside, corners with 0.1 px noise, numpy seed 3. Returns
    (obj, cam_uv, proj_uv) on ``dev`` and the true camera -> projector t."""
    from slr_torch.geom.camera import make_camera, project
    from slr_torch.geom.se3 import so3_exp

    rng = np.random.default_rng(3)
    xx, yy = np.meshgrid(np.arange(9), np.arange(6))
    obj = torch.tensor(np.stack([xx.ravel() * 20.0, yy.ravel() * 20.0,
                                 np.zeros(54)], axis=1), dtype=torch.float32)
    cam = make_camera(1400.0, 1395.0, 640.0, 512.0, dist=[-0.12, 0.05, 0.001, -0.001, 0.0])
    proj = make_camera(1750.0, 1745.0, 512.0, 700.0, dist=[-0.06, 0.02, 0.0, 0.0, 0.0])
    R_cp = so3_exp(torch.tensor([0.0, -0.28, 0.0]))
    t_cp = torch.tensor([180.0, 6.0, 40.0])
    cam_uv, proj_uv = [], []
    for _ in range(24):
        rv = torch.tensor(rng.uniform(-0.35, 0.35, 3), dtype=torch.float32)
        tv = torch.tensor([rng.uniform(-60, 60), rng.uniform(-50, 50), rng.uniform(420, 640)],
                          dtype=torch.float32)
        pts_w = obj @ so3_exp(rv).T + tv
        uv_c, _ = project(cam, pts_w)
        uv_p, _ = project(proj, pts_w @ R_cp.T + t_cp)
        for uv, out in ((uv_c, cam_uv), (uv_p, proj_uv)):
            out.append(uv + torch.tensor(rng.normal(0, 0.1, uv.shape), dtype=torch.float32))
    return obj.to(dev), torch.stack(cam_uv).to(dev), torch.stack(proj_uv).to(dev), t_cp


def host_syncs(fn):
    """(result, host synchronisations) of ``fn``: torch's sync debug mode
    warns once at every call that waits for the card."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def same_bits(a, b):
    """Two results (nested tuples of tensors) hold the same bits."""
    if isinstance(a, tuple):
        return all(same_bits(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def calibration_phases(dev, counts_of, card):
    """Phases 31-33, config 2: calibration. The 24-view Zhang and stereo
    solves of benchmarks/tpu_matrix.py, gated as there and against the
    reference's readings on the same inputs; then the CLI's image route at
    1280x1024 (8 rendered board views, 34 frames each): corners detected,
    patterns decoded, corners lifted into the projector, camera, projector
    and stereo LM, under the reference's golden gates, twice to the same
    bits, stage by stage. None of it launches a kernel."""
    from slr_torch import calib as cal
    from slr_torch.calib import corners, lm
    from slr_torch.calib import pipeline as cpipe
    from slr_torch.config import CalibConfig, PatternConfig
    from slr_torch.synth.board import board_poses, render_board_view
    from slr_torch.synth.render import default_rig

    def solve(name, fn, gates):
        """``fn`` on the card: no kernel, the same bits twice, its LM steps
        and host syncs, CUDA-event and host-wall ms; then its gates."""
        out, n = counts_of(fn)
        check(not any(n.values()), f"{name}: kernels launched {n}")
        steps = int(lm.lm_solve.steps)
        again, syncs = host_syncs(fn)
        check(same_bits(out, again), f"{name}: two calls differ")
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ms = statistics.median(cuda_ms(fn, 5, 1))
        fields = gates(out)
        emit(name, card=card, ms=ms, ms_of="CUDA events around one solve (host time "
             "included)", host_wall_ms=wall, lm_steps=steps, host_syncs=syncs,
             bit_identical_calls=True, launches=n, **fields)
        return out

    # phase 31: 24-view Zhang; phase 32: the joint stereo solve
    obj, cam_uv, proj_uv, t_cp = calib_v24_case(dev)

    def zhang_gates(r):
        rms, fx_err = float(r.rms), abs(float(r.camera.fx) - 1400.0) / 1400.0
        check(fx_err < 5e-3 and rms < 0.3, f"calib_zhang_v24: fx {fx_err}, RMS {rms}")
        check(abs(rms - V24_ZHANG_RMS) <= V24_RMS_TOL,
              f"calib_zhang_v24: RMS {rms}, the reference's {V24_ZHANG_RMS}")
        return dict(views=24, rms_px=rms, fx_rel_err=fx_err, reference_rms_px=V24_ZHANG_RMS)

    rc = solve("calib_zhang_v24", lambda: cal.calibrate_camera(obj, cam_uv), zhang_gates)
    rp = cal.calibrate_camera(obj, proj_uv)

    def stereo_gates(r):
        rms = float(r.rms)
        t_err = float(torch.linalg.norm(r.proj.t.cpu() - t_cp))
        check(t_err < 1.0 and rms < 0.3, f"calib_stereo_v24: t {t_err} mm, RMS {rms}")
        check(abs(rms - V24_STEREO_RMS) <= V24_RMS_TOL and t_err <= V24_T_ERR_MAX,
              f"calib_stereo_v24: RMS {rms}, t {t_err} mm against the reference's")
        return dict(views=24, params=24 + 6 * 24, residuals=2 * 2 * 54 * 24, rms_px=rms,
                    t_rel_err_mm=t_err, reference_rms_px=V24_STEREO_RMS,
                    reference_t_err_mm=0.1728)

    solve("calib_stereo_v24", lambda: cal.stereo_calibrate(obj, cam_uv, proj_uv, rc, rp),
          stereo_gates)

    # phase 33: the CLI's image route at 1280x1024
    cc = CalibConfig()
    cols, rows, sq = cc.board_cols, cc.board_rows, cc.square_size
    cam, proj = default_rig(*CALIB_CAM, device=dev)
    cfg = PatternConfig(proj_width=CALIB_CAM[2], proj_height=CALIB_CAM[3],
                        row_gray_bits=5, row_phase_steps=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    views = [render_board_view(cam, proj, cfg, R, t, cols, rows, sq, CALIB_CAM[1],
                               CALIB_CAM[0], noise_std=0.003,
                               generator=torch.Generator(device="cuda").manual_seed(i))
             for i, (R, t) in enumerate(board_poses(8, cols, rows, sq, seed=0))]
    torch.cuda.synchronize()
    render_ms = (time.perf_counter() - t0) * 1e3
    whites = [v.white_image for v in views]
    stacks = [v.scan.frames for v in views]

    def calibrate():
        return cal.calibrate_from_images(whites, stacks, cols, rows, sq, cfg,
                                         lm_iters=cc.lm_iters)

    dev_views = corners.detect_chessboard.device_views
    res, n = counts_of(calibrate)
    dev_views = corners.detect_chessboard.device_views - dev_views
    check(not any(n.values()), f"calib_images: kernels launched {n}")
    again, stages = stage_times(cpipe, CALIB_STAGES, calibrate)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    third = calibrate()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    for other in (again, third):
        check(same_bits((res.corners_cam, res.corners_proj, res.stereo),
                        (other.corners_cam, other.corners_proj, other.stereo)),
              "calib_images: two calls differ")
    st = res.stereo
    g = CALIB_GOLDEN
    true_c = torch.stack([v.corners_cam_true for v in views])
    err_c = torch.linalg.norm(res.corners_cam - true_c, dim=-1)
    err_p = torch.linalg.norm(res.corners_proj - torch.stack([v.corners_proj_true
                                                              for v in views]), dim=-1)
    f_rel = {f"{c}_{f}": abs(float(getattr(getattr(st, c), f)) - float(getattr(truth, f)))
             / float(getattr(truth, f)) for c, truth in (("cam", cam), ("proj", proj))
             for f in ("fx", "fy")}
    readings = dict(
        rms_px=float(st.rms), cam_rms_px=float(res.cam_rms), proj_rms_px=float(res.proj_rms),
        f_rel_err=f_rel, cam_cx_off_px=abs(float(st.cam.cx - cam.cx)),
        cam_cy_off_px=abs(float(st.cam.cy - cam.cy)),
        max_dR=float((st.proj.R - proj.R).abs().max()),
        max_dt_mm=float((st.proj.t - proj.t).abs().max()),
        corner_err_px=dict(max=float(err_c.max()), mean=float(err_c.mean())),
        proj_corner_err_px=dict(max=float(err_p.max()), mean=float(err_p.mean())))
    check(readings["rms_px"] < g["rms_px"] and max(f_rel.values()) < g["f_rel"]
          and max(readings["cam_cx_off_px"], readings["cam_cy_off_px"]) < g["c_px"]
          and readings["max_dR"] < g["R_abs"] and readings["max_dt_mm"] < g["t_abs_mm"],
          f"calib_images: golden gates {readings}")
    check(float(err_c.max()) < g["corner_max_px"] and float(err_c.mean()) < g["corner_mean_px"],
          f"calib_images: corners {readings['corner_err_px']}")
    emit("calib_images_1280x1024", card=card, views=8, frames=cfg.num_frames,
         camera=list(CALIB_CAM[:2]), lm_iters=cc.lm_iters, launches=n,
         device_path_views=dev_views, gates=g, **readings, reference=CALIB_REFERENCE,
         bit_identical_calls=True, render_ms=render_ms, calibrate_ms=wall,
         stage_ms=stages, stage_ms_of="the second call, each stage's wall from an idle "
         "card to its result")


def same_cloud(a, b):
    """Two ScanClouds (or any tuples of tensors) the same bits, dtypes and
    shapes."""
    return all(x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
               for x, y in zip(a, b))


def product_phases(dev, counts_of, card, main_path, orbit):
    """Phases 34-39, the product surface (slice 9): the native PLY build and
    the persistence round trips with cameras on the card (``io_card``);
    config 5's 8-scan orbit through ``Session`` (``reconstruct_all``,
    ``register``, ``fuse``, ``fuse_mesh``), held to the direct calls' bytes
    and to config 5's accuracy gates, twice (``session_config5``); config 3
    at full width through ``Session.reconstruct`` on every route
    (``session_routes_1280x1024``); the stream against the sequential loop
    (``stream_config3``); the CLI's demo in a subprocess (``cli_demo``);
    and the viewer on the card against the CPU (``viewer_fused``). Returns
    the session paths' launches by kernel."""
    import shutil
    import sys
    import warnings

    from slr_torch import io as sio
    from slr_torch.config import (
        DecodeConfig, PatternConfig, ReconstructConfig, RegistrationConfig, ScanConfig)
    from slr_torch.geom.camera import make_camera
    from slr_torch.io import ply as sply
    from slr_torch.kernels.build import build_host_library
    from slr_torch import observability as ob
    from slr_torch.pipeline import Session, reconstruct_stream
    from slr_torch.pipeline import registerfuse as rf
    from slr_torch.pipeline import tsdf
    from slr_torch.pipeline.checks import validate_cloud
    from slr_torch.pipeline.reconstruct import reconstruct_dense, reconstruct_scan_hdr
    from slr_torch.pipeline.twocam import reconstruct_two_camera
    from slr_torch.pipeline.viewer import render_cloud_image, render_turntable
    from slr_torch.registration.filters import statistical_outlier_removal
    from slr_torch.synth.render import quantize_frames, render_scan, two_camera_rig
    from slr_torch.synth.scene import spheres_scene

    launches = dict.fromkeys(KERNELS, 0)

    def product(fn):
        """``counts_of`` on a product path; its launches join the kernels
        line's."""
        out, n = counts_of(fn)
        for k, v in n.items():
            launches[k] += v
        return out, n

    def ms_of(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    cam_d, proj_d, cfg = main_path["cam"], main_path["proj"], main_path["cfg"]
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)

    # phase 34: the native PLY writer built by g++ from the checkout, its
    # file the plain writer's bytes, read back bit for bit; calibration as
    # JSON (bits) and as OpenCV YAML (float64 relative pose: 1e-6 on R,
    # 1e-4 mm on t) with the cameras on the card
    t0 = time.perf_counter()
    lib, log = build_host_library(sply.NATIVE_SRC)
    sply.library()
    build_s = time.perf_counter() - t0
    cloud = main_path["cloud"]
    colors = cloud.colors[..., None].expand(-1, -1, 3)
    n_pts, native_ms = ms_of(lambda: sio.write_ply(root / "c.ply", cloud.points,
                                                   mask=cloud.mask, colors=colors))
    _, numpy_ms = ms_of(lambda: sply.write_ply_numpy(root / "c_np.ply", cloud.points,
                                                     mask=cloud.mask, colors=colors))
    check((root / "c.ply").read_bytes() == (root / "c_np.ply").read_bytes(),
          "io_card: native and plain PLY bytes differ")
    (pts, col, nrm), read_ms = ms_of(lambda: sio.read_ply(root / "c.ply"))
    check(torch.equal(torch.from_numpy(pts), cloud.points[cloud.mask].cpu()) and nrm is None
          and col.shape == (n_pts, 3), "io_card: PLY round trip")
    cam2 = make_camera(cam_d.fx, cam_d.fy, cam_d.cx, cam_d.cy, dist=PROJ_DIST, R=proj_d.R,
                       t=proj_d.t, device=dev)
    sio.save_calibration(root / "cal.json", cam_d, proj_d, {"rms": 0.1}, cam2=cam2)
    c, p, meta, c2 = sio.load_calibration(root / "cal.json", with_cam2=True, device=dev)
    check(all(x.device.type == "cuda" for x in (*c, *p, *c2)) and meta == {"rms": 0.1}
          and all(torch.equal(a, b) for a, b in zip((*c, *p, *c2), (*cam_d, *proj_d, *cam2))),
          "io_card: calibration JSON round trip")
    sio.save_calibration_opencv(root / "cal.yml", cam2, proj_d, {"rms": 0.1})
    c, p, meta = sio.load_calibration_opencv(root / "cal.yml", device=dev)
    yaml_err = {"R": max(float((c.R - cam2.R).abs().max()), float((p.R - proj_d.R).abs().max())),
                "t_mm": max(float((c.t - cam2.t).abs().max()), float((p.t - proj_d.t).abs().max())),
                "intrinsics": max(float((a - b).abs().max()) for a, b in
                                  zip((*c[:5], *p[:5]), (*cam2[:5], *proj_d[:5])))}
    check(c.R.device.type == "cuda" and yaml_err["R"] <= 1e-6 and yaml_err["t_mm"] <= 1e-4
          and yaml_err["intrinsics"] == 0.0 and meta == {"rms": 0.1},
          f"io_card: OpenCV YAML round trip {yaml_err}")
    emit("io_card", native_library=lib.name, build_s=build_s, gxx_log=log,
         ply_points=n_pts, ply_bytes=(root / "c.ply").stat().st_size,
         native_write_ms=native_ms, numpy_write_ms=numpy_ms, native_read_ms=read_ms,
         ply_bytes_equal_plain=True, opencv_yaml_max_err=yaml_err)

    # phase 35: config 5 through the session; the same 8 uint8 stacks, rig
    # and settings as ``config5`` (the session's own BA iterations, pg_iters)
    stacks, poses, truths = orbit
    scfg = ScanConfig(pattern=cfg, registration=RegistrationConfig(
        icp_sample_points=C5_SAMPLES, voxel_size=C5_VOXEL), cam_width=CAM_W, cam_height=CAM_H)
    s5 = root / "config5"

    def session_run(first):
        """The session path once: (its files' bytes and arrays, stage walls,
        the launches of reconstruct_all). The first run writes the session;
        the second opens it from disk."""
        stage = {name: ob.span(name) for name in (
            "open_and_add_scans", "reconstruct_all", "register", "fuse", "fuse_mesh")}
        write_ms = []
        with warnings.catch_warnings(), stage["open_and_add_scans"]:
            warnings.simplefilter("ignore")
            if first:
                sess = Session(s5, scfg, device=dev)
                sess.set_calibration(cam_d, proj_d)
                for s in stacks:
                    write_ms.append(ms_of(lambda: sess.add_scan(s))[1])
            else:
                sess = Session(s5, device=dev)
        with stage["reconstruct_all"]:
            _, n_rec = product(sess.reconstruct_all)
        with stage["register"]:
            reg, n_reg = product(sess.register)
        with stage["fuse"]:
            ply, n_fuse = product(sess.fuse)
        with warnings.catch_warnings(record=True) as grown, stage["fuse_mesh"]:
            warnings.simplefilter("always")
            obj, n_mesh = product(sess.fuse_mesh)
        check(n_rec["k1"] == ORBIT_SCANS_CONFIG5 and all(
            v == 0 for k, v in n_rec.items() if k != "k1"), f"session_config5: launches {n_rec}")
        check(n_mesh["obj_text"] == 2 and all(v == 0 for k, v in n_mesh.items()
                                              if k != "obj_text"),
              f"session_config5: fuse_mesh launches {n_mesh}")
        check(n_reg == {**dict.fromkeys(n_reg, 0), "pose_graph": 1, "icp": 4, "icp_polish": 4},
              f"session_config5: register launches {n_reg}")
        out = dict(clouds=[sess.load_cloud(i) for i in range(sess.cloud_count())],
                   reg=sess.load_registration(), ply=Path(ply).read_bytes(),
                   obj=Path(obj).read_bytes())
        check(same_cloud(out["reg"], reg), "session_config5: registration.npz")
        io = dict(scan_write_ms=write_ms)
        if first:
            io["scan_read_ms"] = ms_of(lambda: sess.load_scan(0))[1]
            io["cloud_read_ms"] = ms_of(lambda: sess.load_cloud(0))[1]
            io["scan_npz_mb"] = sess.scan_paths()[0].stat().st_size / 1e6
            io["cloud_npz_mb"] = (s5 / "clouds" / "scan_000.npz").stat().st_size / 1e6
        held = {x.id: x for x in ob.snapshot().spans}
        walls = {name: (held[sp.id].end_ns - held[sp.id].start_ns) / 1e6
                 for name, sp in stage.items()}
        return sess, out, walls, io, dict(
            reconstruct_all=n_rec, register=n_reg, fuse=n_fuse, fuse_mesh=n_mesh), \
            [str(w.message) for w in grown]

    sess, run1, stages1, io, n_session, grown = session_run(True)
    # the direct calls with the session's own arguments
    rc = scfg.registration

    def direct():
        clouds = [reconstruct_dense(s, sess.cam, sess.proj, cfg, scfg.decode, scfg.reconstruct)
                  for s in stacks]
        reg = rf.register_scans_batched(clouds, rc, use_features=True, cam=sess.cam,
                                        loop_closures=True)
        reg = rf.ba_refine(clouds, reg, iters=rc.pg_iters)
        pts, val, col, n_vox = rf.fuse_scans(clouds, reg, rc, capacity=C5_CAPACITY)
        sio.write_ply(root / "direct.ply", pts, mask=val, colors=col.expand(-1, 3))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            vol = tsdf.fuse_tsdf(clouds, sess.cam, reg.R, reg.t, size_vox=C5_TSDF,
                                 voxel=C5_VOXEL)
        written, n_obj = product(lambda: tsdf.write_tsdf_mesh_obj(root / "direct.obj", vol))
        check(n_obj["obj_text"] == 2 and all(v == 0 for k, v in n_obj.items()
                                             if k != "obj_text"),
              f"session_config5: the direct writer's launches {n_obj}")
        return clouds, reg, pts, val, n_vox, vol, written

    (clouds_d, reg_d, pts_d, val_d, n_vox, vol_d, written), direct_ms = ms_of(direct)
    check(all(same_cloud(a, b) for a, b in zip(run1["clouds"], clouds_d)),
          "session_config5: clouds differ from the direct calls'")
    check(same_cloud(run1["reg"], reg_d), "session_config5: poses differ from the direct call's")
    check(run1["ply"] == (root / "direct.ply").read_bytes(),
          "session_config5: fused.ply differs from the direct call's bytes")
    check(run1["obj"] == (root / "direct.obj").read_bytes(),
          "session_config5: fused_mesh.obj differs from the direct call's bytes")
    verts = tsdf.extract_mesh(vol_d)[0]
    acc = config5_accuracy("session_config5", reg_d, pts_d, val_d, verts, written[1],
                           clouds_d, poses, truths)
    # the same bits in a second run, the session opened from disk
    _, run2, stages2, _, _, _ = session_run(False)
    same = (run1["ply"] == run2["ply"] and run1["obj"] == run2["obj"]
            and same_cloud(run1["reg"], run2["reg"])
            and all(same_cloud(a, b) for a, b in zip(run1["clouds"], run2["clouds"])))
    check(same, "session_config5: two runs differ")
    emit("session_config5", scans=ORBIT_SCANS_CONFIG5, launches=n_session,
         bit_equal_direct_call=True, bit_identical_runs=same, **acc,
         ba_iters=rc.pg_iters, icp_rms_mm=reg_d.icp_rms.tolist(), n_voxels=int(n_vox),
         ply_bytes=len(run1["ply"]), obj_bytes=len(run1["obj"]), tsdf_warnings=grown,
         stage_ms_first=stages1, stage_ms=stages2, session_ms_first=sum(stages1.values()),
         session_ms=sum(stages2.values()), direct_ms=direct_ms, **io, card=card,
         stage_timing="host wall (the recorder's spans), the card synchronised at each end; "
                      "the first run writes the 8 scans, the second opens the session from disk")

    # phase 36: config 3 at full width through Session.reconstruct, every
    # route: the direct call's bits and launches
    frames, frames8, bracket = main_path["frames"], main_path["frames8"], main_path["bracket"]
    sr = root / "routes"
    base = dict(pattern=cfg, cam_width=CAM_W, cam_height=CAM_H)
    sess = Session(sr, ScanConfig(**base), device=dev)
    sess.set_calibration(cam_d, proj_d)
    idx = {"float32": sess.add_scan(frames), "uint8": sess.add_scan(frames8),
           "bracket": sess.add_scan(bracket)}
    dec0, rec0 = DecodeConfig(), ReconstructConfig()
    wave = DecodeConfig(spatial_unwrap_mode="wavefront")
    sor = ReconstructConfig(sor_k=8)

    def dense(f, dec=dec0, rec=rec0, spatial_iters=0):
        return lambda: reconstruct_dense(f, cam_d, proj_d, cfg, dec, rec,
                                         spatial_iters=spatial_iters,
                                         spatial_mode=dec.spatial_unwrap_mode)

    def with_sor(f):
        c = dense(f, rec=sor)()
        keep = statistical_outlier_removal(c.points.reshape(-1, 3), c.mask.reshape(-1),
                                           sor.sor_voxel, k=sor.sor_k,
                                           std_ratio=sor.sor_std_ratio).reshape(CAM_H, CAM_W)
        return c._replace(mask=c.mask & keep)

    def checked(f):
        c = dense(f)()
        validate_cloud(c).throw()
        return c

    one_k1 = dict(k1=1)
    routes = {  # name: (config overrides, scan, reconstruct kwargs, direct call, launches)
        "float32": ({}, "float32", {}, dense(frames), one_k1),
        "uint8": ({}, "uint8", {}, dense(frames8), one_k1),
        "voting": ({}, "float32", dict(spatial_iters=SPATIAL_ITERS),
                   dense(frames, spatial_iters=SPATIAL_ITERS), dict(k1=1, k4=1)),
        "wavefront": (dict(decode=wave), "float32", dict(spatial_iters=SPATIAL_ITERS),
                      dense(frames, dec=wave, spatial_iters=SPATIAL_ITERS), dict(k1=1, k5=8)),
        "bracket": ({}, "bracket", {}, lambda: reconstruct_scan_hdr(
            bracket, cam_d, proj_d, cfg, dec0, rec0), dict(k2=1)),
        "checked": (dict(reconstruct=ReconstructConfig(checked=True)), "float32", {},
                    lambda: checked(frames), one_k1),
        "sor": (dict(reconstruct=sor), "float32", {}, lambda: with_sor(frames), one_k1),
    }
    results = {}
    for name, (over, scan, kw, call, expect) in routes.items():
        s = Session(sr, ScanConfig(**base, **over), device=dev)
        (c, n), ms = ms_of(lambda: product(lambda: s.reconstruct(idx[scan], **kw)))
        d, nd = counts_of(call)
        want = {k: expect.get(k, 0) for k in n}
        check(n == nd == want, f"session route {name}: launches {n}, direct {nd}, want {want}")
        check(same_cloud(c, d) and same_cloud(s.load_cloud(idx[scan]), c),
              f"session route {name}: not the direct call's bits, or not its stage file's")
        results[name] = dict(launches={k: v for k, v in n.items() if v}, ms=ms,
                             valid_px=int(c.mask.sum()))
    # the two-camera pair (uint8, the merge's config-3-width rig)
    cfg2 = PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=7, row_gray_bits=6,
                         phase_steps=4, row_phase_steps=4)
    rec2 = ReconstructConfig(min_depth=300.0, max_depth=900.0)
    c1, c2, proj2 = two_camera_rig(CAM_W, CAM_H, PROJ_W, PROJ_H, device=dev)
    f1, f2 = (quantize_frames(render_scan(
        c, proj2, spheres_scene(c, CAM_H, CAM_W), cfg2, noise_std=0.003, cast_shadows=True,
        generator=torch.Generator(device=dev).manual_seed(20 + i)).frames)
        for i, c in enumerate((c1, c2)))
    s2 = Session(root / "two_camera", ScanConfig(pattern=cfg2, reconstruct=rec2,
                                                 cam_width=CAM_W, cam_height=CAM_H), device=dev)
    s2.set_calibration(c1, proj2, cam2=c2)
    s2.add_scan(f1, frames2=f2)
    (c, n), ms = ms_of(lambda: product(lambda: s2.reconstruct(0)))
    d, nd = counts_of(lambda: reconstruct_two_camera(f1, f2, c1, c2, cfg2, DecodeConfig(), rec2))
    want = {k: {"k1": 2, "k7": 4}.get(k, 0) for k in n}
    check(n == nd == want, f"session route two_camera: launches {n}, direct {nd}")
    check(same_cloud(c, d), "session route two_camera: not the direct call's bits")
    results["two_camera"] = dict(launches={k: v for k, v in n.items() if v}, ms=ms,
                                 valid_cells=int(c.mask.sum()))
    emit("session_routes_1280x1024", bit_equal_direct_calls=True, routes=results,
         ms_timing="host wall of Session.reconstruct (the .npz read of the scan and the "
                   "write of its cloud included), one call")

    # phase 37: the stream against the sequential loop on 8 config-3 uint8
    # stacks (the orbit's), from the host: the same bits; walls in turns
    host = [s.cpu().numpy() for s in stacks]
    pinned = [torch.from_numpy(h).pin_memory() for h in host]
    dec = DecodeConfig()

    def sequential(src):
        return [reconstruct_dense(torch.as_tensor(h).to(dev), cam_d, proj_d, cfg, dec)
                for h in src]

    def streamed(src, prefetch):
        return list(reconstruct_stream(iter(src), cam_d, proj_d, cfg, dec, prefetch=prefetch,
                                       device=dev))

    ref, _ = counts_of(lambda: sequential(host))
    stream_runs = {"prefetch1": lambda: streamed(host, 1), "prefetch2": lambda: streamed(host, 2),
                   "prefetch2_pinned": lambda: streamed(pinned, 2)}
    for name, fn in stream_runs.items():
        got, n = product(fn)
        check(n["k1"] == len(host) and all(same_cloud(a, b) for a, b in zip(got, ref)),
              f"stream {name}: launches {n['k1']} or bits differ from the sequential loop")
    runs = {"sequential": lambda: sequential(host), **stream_runs,
            "resident": lambda: [reconstruct_dense(s, cam_d, proj_d, cfg, dec) for s in stacks]}
    walls = {k: [] for k in runs}
    for turn in range(5):
        for name in (list(runs) if turn % 2 == 0 else list(runs)[::-1]):
            walls[name].append(ms_of(runs[name])[1])
    wall = {k: statistics.median(v) for k, v in walls.items()}
    copy = {"pinned_ms": statistics.median(cuda_ms(
        lambda: pinned[0].to(dev, non_blocking=True), runs=10)),
            "pageable_ms": statistics.median(cuda_ms(
                lambda: torch.from_numpy(host[0]).to(dev), runs=10))}
    exposed = wall["sequential"] - wall["resident"]
    emit("stream_config3", scans=len(host), stack_mb=host[0].nbytes / 1e6,
         bit_equal_sequential=True, wall_ms=wall,
         wall_ms_spread={k: [min(v), max(v)] for k, v in walls.items()}, copy_ms=copy,
         copy_hidden_share={k: (wall["sequential"] - wall[k]) / exposed
                            for k in stream_runs} if exposed > 0 else None,
         hidden_share_rule="(sequential - stream) / (sequential - stacks already resident)",
         card=card)

    # phase 38: the CLI's demo in a subprocess, at its own defaults
    out_dir = root / "demo"
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "slr_torch.cli", "demo", "--out",
                           str(out_dir)], cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=600)
    demo_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"cli demo: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    calib_rms = json.loads((out_dir / "calibration.json").read_text())["meta"]["rms"]
    check(calib_rms < 0.5, f"cli demo: calibration RMS {calib_rms} px")
    fused_n = sio.read_ply(out_dir / "fused.ply")[0].shape[0]
    check(fused_n > 0, "cli demo: empty fused.ply")
    emit("cli_demo", rc=proc.returncode, wall_s=demo_s, calib_rms_px=calib_rms,
         fused_points=fused_n, stdout=proc.stdout.splitlines())

    # phase 39: the viewer on the fused cloud, on the card and on the CPU
    pts, col, _ = sio.read_ply(s5 / "fused.ply")
    on_card, card_ms = ms_of(lambda: render_turntable(pts, col, root / "view_card", frames=2,
                                                      device=dev))
    on_cpu, cpu_ms = ms_of(lambda: render_turntable(pts, col, root / "view_cpu", frames=2,
                                                    device="cpu"))
    img = render_cloud_image(pts, col, device=dev)
    check(img.device.type == "cuda" and torch.equal(img.cpu(), render_cloud_image(pts, col))
          and all(Path(a).read_bytes() == Path(b).read_bytes() for a, b in zip(on_card, on_cpu)),
          "viewer_fused: the card's image differs from the CPU's")
    emit("viewer_fused", points=int(pts.shape[0]), views=len(on_card),
         files=[Path(f).name for f in on_card], bit_equal_cpu=True,
         lit_share=float((img.sum(-1) > 0).float().mean()), card_ms=card_ms, cpu_ms=cpu_ms)
    tmp.cleanup()
    return launches


# --- the parallel tier (slr_torch.dist): ranks as subprocesses of this script

DIST_SWEEPS = 8                # repair sweeps of the sharded config-3 scan (2 exchanges)
DIST_TILES = 4                 # pixel tiles of the one-card Gloo world: rows 0/256/512/768
DIST_GLOO_WORLD = 4
DIST_BA = dict(S=6, L=4096, K=3, iters=10)   # tpu_matrix.py:412-433, schur_ba_S6_L4096_10iter
DIST_BA_RMS_GATE = 0.05                      # tpu_matrix.py:443
# the distributed BA against the single-device one (tests/test_dist.py:169-175)
DIST_T_TOL, DIST_R_TOL, DIST_X_TOL, DIST_RMS_RTOL = 1e-3, 1e-5, 1e-3, 1e-3
# config 5's poses sharded against unsharded: the batched registration's
# bounds (tests/test_torch_registerfuse.py:298-300)
DIST_C5_R_TOL, DIST_C5_T_TOL = 1e-4, 2e-2
DIST_TIMED = 3                 # timed runs a sharded call, median
DIST_TIMEOUT_S = 420           # a world's wall and its process group's timeout


def digest(*tensors):
    """SHA-256 of the tensors' shapes, dtypes and bytes: equal digests are
    equal bits."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        t = torch.as_tensor(t).detach().contiguous().cpu()
        h.update(f"{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


KERNELS = ("k1", "k2", "k3", "k4", "k5", "k8", "k6", "k7", "obj_text", "pose_graph", "icp",
           "icp_polish")


def launch_counts() -> dict:
    """Every kernel's launches so far, from the recorder's ``launches.*``
    counters."""
    from slr_torch import observability as ob

    counts = ob.snapshot().counts
    return {k: counts.get(f"launches.{k}", 0) for k in KERNELS}


def launches_of(fn):
    """(``fn()``, the launches of each kernel in it); the card is waited on
    before they are read."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = launch_counts()
    return out, {k: after[k] - before[k] for k in KERNELS}


def dist_counted(fn, staged):
    """``fn()`` with every launch count and the collectives' counts set to 0
    just before; returns (result, launches, collective calls, bytes sent)
    read just after. ``staged`` collects the ops Gloo staged through the
    host."""
    from slr_torch.dist import comm

    comm.reset()
    out, launches = launches_of(fn)
    staged.update(comm.staged)
    return out, launches, dict(comm.calls), dict(comm.sent_bytes)


def dist_wall_ms(fn, runs=DIST_TIMED):
    """Median host wall (ms) of ``fn()``, the card synchronised at each
    end; every rank runs it the same number of times."""
    ts = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def dist_inputs_camera(inp, prefix, dev):
    from slr_torch.geom.camera import Camera

    return Camera(*(torch.from_numpy(inp[f"{prefix}_{f}"]).to(dev) for f in Camera._fields))


def dist_job_config3(job, inp, dev, staged):
    """The config-3 stack (float32 and uint8) through ``sharded_reconstruct``
    at 0 and DIST_SWEEPS sweeps over ``pixel_tiles`` tiles."""
    from types import SimpleNamespace

    from slr_torch.config import DecodeConfig, PatternConfig
    from slr_torch.dist import make_mesh, sharded_reconstruct

    mesh = make_mesh(pixel_tiles=job["pixel_tiles"])
    cam, proj = dist_inputs_camera(inp, "cam", dev), dist_inputs_camera(inp, "proj", dev)
    cfg = PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=7, phase_steps=4)
    truth = SimpleNamespace(points_true=torch.from_numpy(inp["points_true"]).to(dev),
                            mask_true=torch.from_numpy(inp["mask_true"]).to(dev))
    out = {"coords": dict(mesh.coords), "shape": dict(mesh.shape)}
    for name in ("float32", "uint8"):
        frames = torch.from_numpy(inp[f"frames_{name}"]).to(dev)
        for it in (0, DIST_SWEEPS):
            def run():
                return sharded_reconstruct(frames, cam, proj, cfg, DecodeConfig(), mesh,
                                           spatial_iters=it)

            res, n, calls, sent = dist_counted(run, staged)
            rms, valid = rms_vs_truth(res[0], res[1], truth)
            out[(name, it)] = dict(digest=[digest(t) for t in res], launches=n, calls=calls,
                                   sent=sent, rms_mm=rms, valid_points=valid,
                                   again=[digest(t) for t in run()],
                                   ms=dist_wall_ms(run))
    return out


def dist_ba_problem():
    """tpu_matrix.py:412-433's BA case (numpy seed 7): S poses, L landmarks
    seen K times each, 0.01 mm noise, the poses and landmarks perturbed."""
    from slr_torch.geom.se3 import so3_exp

    r = np.random.default_rng(7)
    S, L, K = DIST_BA["S"], DIST_BA["L"], DIST_BA["K"]
    f32 = dict(dtype=torch.float32)
    R_true = torch.stack([torch.eye(3)] + [so3_exp(torch.tensor(r.uniform(-0.3, 0.3, 3), **f32))
                                           for _ in range(1, S)])
    t_true = torch.cat([torch.zeros(1, 3), torch.tensor(r.uniform(-50, 50, (S - 1, 3)), **f32)])
    X_true = torch.tensor(r.uniform(-100, 100, (L, 3)), **f32)
    obs_s = torch.tensor(r.integers(0, S, (L, K)), dtype=torch.int64)
    p = torch.einsum("lkij,lki->lkj", R_true[obs_s], X_true[:, None, :] - t_true[obs_s])
    p = p + torch.tensor(r.normal(0, 0.01, tuple(p.shape)), **f32)
    R0 = R_true @ so3_exp(torch.tensor(r.normal(0, 0.02, (S, 3)), **f32))
    t0 = t_true + torch.tensor(r.normal(0, 2.0, (S, 3)), **f32)
    X0 = X_true + torch.tensor(r.normal(0, 2.0, (L, 3)), **f32)
    return dict(ba_R0=R0, ba_t0=t0, ba_X0=X0, ba_s=obs_s, ba_p=p, ba_w=torch.ones(L, K))


def dist_job_ba(job, inp, dev, staged):
    """``distributed_bundle_adjust`` on DIST_BA over ``map_blocks`` blocks,
    twice, and its time a Gauss-Newton iteration."""
    from slr_torch.dist import distributed_bundle_adjust, make_mesh

    n = torch.distributed.get_world_size()
    mesh = make_mesh(pixel_tiles=n // job["map_blocks"], map_blocks=job["map_blocks"])
    args = [torch.from_numpy(inp[k]).to(dev)
            for k in ("ba_R0", "ba_t0", "ba_X0", "ba_s", "ba_p", "ba_w")]

    def run():
        return distributed_bundle_adjust(*args, mesh, iters=DIST_BA["iters"])

    res, launches, calls, sent = dist_counted(run, staged)
    again = run()
    return dict(result=[t.cpu() for t in res], again=[digest(t) for t in again],
                launches=launches, calls=calls, sent=sent,
                ms_per_iter=dist_wall_ms(run) / DIST_BA["iters"])


def dist_job_config5(job, inp, dev, staged):
    """Config 5 on the orbit over a ``map_blocks`` x ``pixel_tiles`` mesh
    (``config5_run``): digests of every output, the poses, stage walls;
    rank 0 also returns the fused cloud and the mesh for the accuracy
    gates."""
    from slr_torch.config import PatternConfig
    from slr_torch.dist import make_mesh

    mesh = make_mesh(pixel_tiles=job["pixel_tiles"], map_blocks=job["map_blocks"])
    cam, proj = dist_inputs_camera(inp, "cam", dev), dist_inputs_camera(inp, "proj", dev)
    cfg = PatternConfig(proj_width=PROJ_W, proj_height=PROJ_H, gray_bits=7, phase_steps=4)
    stacks = torch.from_numpy(inp["orbit"]).to(dev)
    stages, stages2 = {}, {}
    t0 = time.perf_counter()
    (clouds, reg, fused, vol, surface, _, _), n, calls, sent = dist_counted(
        lambda: config5_run(stacks, cam, proj, cfg, mesh, stages), staged)
    wall = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    again = config5_run(stacks, cam, proj, cfg, mesh, stages2)
    wall2 = (time.perf_counter() - t0) * 1e3

    def digests(clouds, reg, fused, vol, surface):
        return dict(clouds=[digest(*c) for c in clouds], reg_digest=digest(*reg),
                    fused=digest(*fused), volume=digest(vol.tsdf, vol.weight, vol.color),
                    surface=digest(*surface))

    out = dict(launches=n, calls=calls, sent=sent, wall_ms_first=wall, wall_ms=wall2,
               stage_ms_first=stages, stage_ms=stages2, reg=[t.cpu() for t in reg],
               again=digests(*again[:5]), **digests(clouds, reg, fused, vol, surface))
    if torch.distributed.get_rank() == 0:
        out.update(pts=fused[0].cpu(), val=fused[1].cpu(), verts=surface[0].cpu(),
                   faces=surface[1].cpu())
    return out


DIST_JOBS = {"config3": dist_job_config3, "ba": dist_job_ba, "config5": dist_job_config5}


def dist_rank(argv):
    """One rank: ``chip_smoke.py --dist-rank RANK WORLD BACKEND STORE
    WORKDIR``. Joins the job (a world of one through a process group of its
    own, which ``init_distributed`` skips; Gloo ranks all on ``cuda:0``),
    runs ``WORKDIR/task.json``'s jobs and writes ``WORKDIR/rank<r>.pt``."""
    from datetime import timedelta

    import torch.distributed as dist

    from slr_torch.dist import init_distributed

    rank, world, backend, store, workdir = (int(argv[0]), int(argv[1]), argv[2], argv[3],
                                            Path(argv[4]))
    task = json.loads((workdir / "task.json").read_text())
    if world == 1:
        torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=store, world_size=1, rank=0,
                                timeout=timedelta(seconds=DIST_TIMEOUT_S))
    else:
        init_distributed(store, world, rank, backend=backend,
                         device="cuda:0" if backend == "gloo" else None,
                         timeout_s=DIST_TIMEOUT_S)
    dev = torch.device("cuda", torch.cuda.current_device())
    inp = np.load(workdir / "inputs.npz")
    staged = set()
    out = {"rank": rank, "device": str(dev), "backend": dist.get_backend()}
    for job in task["jobs"]:
        out[job["name"]] = DIST_JOBS[job["kind"]](job, inp, dev, staged)
    out["staged"] = sorted(staged)
    torch.save(out, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()


def dist_world(workdir, world, backend, jobs):
    """Starts ``world`` ranks of this script (their output to log files, not
    this script's stdout), waits for them (at most DIST_TIMEOUT_S) and
    returns each rank's results and the world's wall (s); kills every rank
    if one fails or the world outlives its time."""
    import shutil

    wd = Path(workdir) / f"{backend}{world}"
    shutil.rmtree(wd, ignore_errors=True)
    wd.mkdir(parents=True)
    (wd / "task.json").write_text(json.dumps({"jobs": jobs}))
    (wd / "inputs.npz").symlink_to(Path(workdir) / "inputs.npz")
    store = f"file://{wd / 'store'}"
    logs = [open(wd / f"rank{r}.log", "wb") for r in range(world)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dist-rank",
                               str(r), str(world), backend, store, str(wd)],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        deadline = time.monotonic() + DIST_TIMEOUT_S
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    if any(rcs):
        for r in range(world):
            sys.stderr.write(f"--- {backend} rank {r} (rc {rcs[r]}):\n"
                             + (wd / f"rank{r}.log").read_text()[-4000:] + "\n")
        check(False, f"a {backend} world of {world} ranks: exit codes {rcs}")
    return [torch.load(wd / f"rank{r}.pt", weights_only=False) for r in range(world)], wall


def dist_phases(dev, card, main_path, orbit, config5_one):
    """The parallel tier on the card (``slr_torch.dist``), ranks as
    subprocesses of this script after every kernel is built:

    - ``dist_world1_nccl``: a process group of one rank over NCCL: the
      config-3 stack (float32 and uint8) through ``sharded_reconstruct`` at
      0 and DIST_SWEEPS sweeps (K1, then K4 on the haloed 1032-row block),
      and the distributed BA on DIST_BA (one all-reduce an iteration);
    - ``dist_one_card_gloo``: DIST_GLOO_WORLD ranks sharing ``cuda:0`` over
      Gloo (named, as a card shared needs): config 3 over 4 pixel tiles (K1
      at rows 0/256/512/768, K3 on each 264-row haloed block, 2 ring
      exchanges a scan), the BA over 4 map blocks, and config 5 on the
      orbit over a 2 x 2 layout (the batch, the registration's edges and
      the BA's landmarks over 2 map blocks, then the voxel fuse and the
      TSDF mesh);
    - ``dist_nccl_multi_gpu``: an NCCL world of min(GPUs, 4) where the
      machine has 2 GPUs or more; else one line saying so.

    Gated: sharded config 3 at 0 sweeps equal to the unsharded K1 call bit
    for bit (digests), at DIST_SWEEPS sweeps equal to the unsharded
    composition (K1, ``quality_unwrap``, ``triangulate_plane``) on every
    rank of every world, RMS <= RMS_GATE_MM, K1 once a rank, K3/K4 by their
    route on the block, the ring's calls and bytes those of
    ``comm_halo_bytes``; the BA within tests/test_dist.py's bounds of
    ``bundle_adjust_reference`` on the card, the same bits on every rank
    and in two runs, one all-reduce an iteration, rms < DIST_BA_RMS_GATE;
    config 5's clouds the single-device bits, its poses within
    DIST_C5_R_TOL / DIST_C5_T_TOL of the single-device run, config 5's
    accuracy gates, every output the same on every rank. Four ranks
    time-slice one card, so their times are not scaling numbers. Returns
    the K1, K3 and K4 launches of the ranks' counted runs."""
    from slr_torch import observability as ob
    from slr_torch.codec import unwrap as pu
    from slr_torch.config import DecodeConfig
    from slr_torch.dist import bundle_adjust_reference
    from slr_torch.geom.triangulate import triangulate_plane
    from slr_torch.kernels import fused_scan as fs
    from slr_torch.kernels import unwrap_scan as us
    from slr_torch.pipeline.reconstruct import _pixel_grid

    cam_d, proj_d, cfg = main_path["cam"], main_path["proj"], main_path["cfg"]
    scan = main_path["scan"]
    stacks, poses, truths = orbit
    tmp = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    problem = dist_ba_problem()
    np.savez(Path(tmp.name) / "inputs.npz",
             frames_float32=main_path["frames"].cpu().numpy(),
             frames_uint8=main_path["frames8"].cpu().numpy(),
             points_true=scan.points_true.cpu().numpy(), mask_true=scan.mask_true.cpu().numpy(),
             orbit=torch.stack(list(stacks)).cpu().numpy(),
             **{f"{p}_{f}": x.cpu().numpy() for p, c in (("cam", cam_d), ("proj", proj_d))
                for f, x in zip(c._fields, c)},
             **{k: v.numpy() for k, v in problem.items()})
    setup_s = time.perf_counter() - t0

    # the single-device oracles, on the card
    H, W = CAM_H, CAM_W
    oracle3 = {}
    for name, frames in (("float32", main_path["frames"]), ("uint8", main_path["frames8"])):
        out = fs.fused_decode_triangulate(frames, cam_d, proj_d, cfg, DecodeConfig())
        mask = out.mask > 0.5
        oracle3[(name, 0)] = [digest(t) for t in (out.points.movedim(0, -1), mask, out.x_p,
                                                 out.quality)]
        Phi = pu.spatial_quality_unwrap(out.x_p * (2.0 * math.pi / cfg.fringe_pitch),
                                        out.quality, mask, iters=DIST_SWEEPS)
        x_p = Phi * (cfg.fringe_pitch / (2.0 * math.pi))
        pts, _ = triangulate_plane(cam_d, proj_d, *_pixel_grid(H, W, dev), x_p)
        oracle3[(name, DIST_SWEEPS)] = [digest(t) for t in (pts, mask, x_p, out.quality)]
    ba_args = [problem[k].to(dev) for k in ("ba_R0", "ba_t0", "ba_X0", "ba_s", "ba_p", "ba_w")]
    ba_ref = [t.cpu() for t in bundle_adjust_reference(*ba_args, iters=DIST_BA["iters"])]
    c5_clouds, c5_reg, c5_stages = (config5_one[k] for k in ("clouds", "reg", "stages"))
    c5_ref_digests = [digest(*c) for c in c5_clouds]

    def block_launches(world, sweeps, h=4):
        """K3 and K4 launches a rank for ``sweeps`` sweeps in exchanges of
        ``h`` on its haloed block (``quality_unwrap``'s route)."""
        rows = H // world + 2 * h
        k3 = us.takes_resident(rows, W, us.resident_layout(dev.index or 0))
        n_ex = -(-sweeps // h)
        return (n_ex, 0) if k3 else (0, n_ex * -(-h // us.MAX_HALO))

    totals = {"k1": 0, "k3": 0, "k4": 0, "pose_graph": 0, "icp": 0, "icp_polish": 0}

    def gate_config3(name, results, world):
        rows = []
        for r, res in enumerate(results):
            c3 = res["config3"]
            check(c3["coords"]["pixel_tile"] == r % world and c3["shape"]["pixel_tile"] == world,
                  f"{name}: rank {r} mesh {c3['coords']}")
            for key, ref in oracle3.items():
                got = c3[key]
                check(got["digest"] == ref and got["again"] == ref,
                      f"{name}: rank {r} {key} differs from the unsharded result")
                check(got["rms_mm"] <= RMS_GATE_MM, f"{name}: {key} RMS {got['rms_mm']}")
                k3, k4 = block_launches(world, key[1]) if key[1] else (0, 0)
                want = dict.fromkeys(got["launches"], 0)
                want.update(k1=1, k3=k3, k4=k4)
                check(got["launches"] == want, f"{name}: rank {r} {key} launches "
                                               f"{got['launches']}, want {want}")
                n_ex = -(-key[1] // 4) if world > 1 else 0
                check(got["calls"]["ring"] == n_ex and got["calls"]["all_gather"] == 1
                      and got["sent"]["ring"] == ob.comm_halo_bytes(W, 4, 4, 3, n_ex),
                      f"{name}: rank {r} {key} collectives {got['calls']} {got['sent']}")
                for k in totals:
                    totals[k] += got["launches"][k]
            rows.append(c3)
        return {f"{k[0]}_sweeps{k[1]}": dict(
            ms=[c[k]["ms"] for c in rows], rms_mm=rows[0][k]["rms_mm"],
            valid_points=rows[0][k]["valid_points"], launches_rank0=rows[0][k]["launches"],
            ring_calls=rows[0][k]["calls"]["ring"], ring_bytes=rows[0][k]["sent"]["ring"],
            gather_bytes=rows[0][k]["sent"]["all_gather"],
            row_offsets=[c["coords"]["pixel_tile"] * (H // world) for c in rows])
            for k in oracle3}

    def gate_ba(name, results):
        first = results[0]["ba"]
        R, t, X, cost, rms = first["result"]
        for r, res in enumerate(results):
            ba = res["ba"]
            check([digest(x) for x in ba["result"]] == ba["again"]
                  == [digest(x) for x in first["result"]],
                  f"{name}: BA rank {r} differs from rank 0 or from its second run")
            check(ba["calls"]["all_reduce"] == DIST_BA["iters"] and ba["calls"]["all_gather"] == 1
                  and not any(ba["launches"].values()), f"{name}: BA {ba['calls']}")
            check(ba["sent"]["all_reduce"] * 2 == ob.comm_schur_bytes(DIST_BA["S"], DIST_BA["iters"]),
                  f"{name}: BA all-reduce bytes {ba['sent']}")
        errs = dict(t=float((t - ba_ref[1]).abs().max()), R=float((R - ba_ref[0]).abs().max()),
                    X=float((X - ba_ref[2]).abs().max()),
                    rms_rel=abs(float(rms) / float(ba_ref[4]) - 1))
        check(errs["t"] <= DIST_T_TOL and errs["R"] <= DIST_R_TOL and errs["X"] <= DIST_X_TOL
              and errs["rms_rel"] <= DIST_RMS_RTOL, f"{name}: BA against the reference {errs}")
        check(float(rms) < DIST_BA_RMS_GATE, f"{name}: BA rms {float(rms)}")
        return dict(rms=float(rms), reference_rms=float(ba_ref[4]), vs_reference=errs,
                    ms_per_iter=[res["ba"]["ms_per_iter"] for res in results],
                    all_reduce_calls=first["calls"]["all_reduce"],
                    all_reduce_bytes=first["sent"]["all_reduce"])

    def gate_config5(name, results):
        first = results[0]["config5"]
        for r, res in enumerate(results):
            c5 = res["config5"]
            check(c5["clouds"] == c5_ref_digests, f"{name}: rank {r} clouds differ from one "
                                                  "device's")
            mine = {k: c5[k] for k in c5["again"]}
            check(mine == c5["again"] == {k: first[k] for k in c5["again"]},
                  f"{name}: rank {r} differs from rank 0 or from its second run")
            want = dict.fromkeys(c5["launches"], 0)
            want.update(k1=ORBIT_SCANS_CONFIG5 // 2, pose_graph=1, icp=4, icp_polish=4)
            check(c5["launches"] == want, f"{name}: config 5 launches {c5['launches']}")
            for k in ("k1", "pose_graph", "icp", "icp_polish"):
                totals[k] += c5["launches"][k]
        R, t = first["reg"][0].to(dev), first["reg"][1].to(dev)
        dR, dt = float((R - c5_reg.R).abs().max()), float((t - c5_reg.t).abs().max())
        check(dR <= DIST_C5_R_TOL and dt <= DIST_C5_T_TOL,
              f"{name}: config 5 poses {dR} / {dt} mm from one device's")
        reg = type(c5_reg)(*(x.to(dev) for x in first["reg"]))
        acc = config5_accuracy(name, reg, first["pts"].to(dev), first["val"].to(dev),
                               first["verts"].to(dev), int(first["faces"].shape[0]),
                               c5_clouds, poses, truths)
        return dict(poses_vs_one_device=dict(R=dR, t_mm=dt), **acc,
                    wall_ms=[res["config5"]["wall_ms"] for res in results],
                    wall_ms_first=[res["config5"]["wall_ms_first"] for res in results],
                    stage_ms_rank0=first["stage_ms"], one_device_stage_ms=c5_stages,
                    one_device_wall_ms=sum(v for k, v in c5_stages.items()
                                           if k != "write_tsdf_mesh_obj"),
                    wall="a rank's second run (its first, in a fresh process, in "
                         "wall_ms_first); one device: config5's second call, its OBJ "
                         "writer left out, as the ranks run none",
                    gathers=first["calls"]["all_gather"],
                    all_reduce=first["calls"]["all_reduce"])

    # phase: a real process group of one rank over NCCL
    jobs = [dict(name="config3", kind="config3", pixel_tiles=1),
            dict(name="ba", kind="ba", map_blocks=1)]
    results, wall = dist_world(tmp.name, 1, "nccl", jobs)
    c3_one = gate_config3("dist_world1_nccl", results, 1)
    ba_one = gate_ba("dist_world1_nccl", results)
    emit("dist_world1_nccl", card=card, backend=results[0]["backend"],
         staged=results[0]["staged"], config3=c3_one, ba=ba_one, world_s=wall,
         inputs_setup_s=setup_s,
         timing="host wall a call, median of 3, the card synchronised at each end")

    # phase: DIST_GLOO_WORLD ranks sharing one card over Gloo
    jobs = [dict(name="config3", kind="config3", pixel_tiles=DIST_TILES),
            dict(name="ba", kind="ba", map_blocks=DIST_GLOO_WORLD),
            dict(name="config5", kind="config5", pixel_tiles=2, map_blocks=2)]
    results, wall = dist_world(tmp.name, DIST_GLOO_WORLD, "gloo", jobs)
    check(all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in results),
          "gloo ranks off cuda:0")
    emit("dist_one_card_gloo", card=card, backend="gloo", ranks=DIST_GLOO_WORLD,
         staged=sorted({op for r in results for op in r["staged"]}),
         config3=gate_config3("dist_one_card_gloo", results, DIST_TILES),
         ba=gate_ba("dist_one_card_gloo", results),
         config5=gate_config5("dist_one_card_gloo", results), world_s=wall,
         timing=f"{DIST_GLOO_WORLD} ranks time-slice one card: not scaling numbers")

    # phase: an NCCL world over several GPUs, where the machine has them
    gpus = torch.cuda.device_count()
    if gpus >= 2:
        world = min(gpus, 4)
        jobs = [dict(name="config3", kind="config3", pixel_tiles=world),
                dict(name="ba", kind="ba", map_blocks=world)]
        if world == 4:
            jobs.append(dict(name="config5", kind="config5", pixel_tiles=2, map_blocks=2))
        results, wall = dist_world(tmp.name, world, "nccl", jobs)
        emit("dist_nccl_multi_gpu", ran=True, card=card, ranks=world,
             staged=sorted({op for r in results for op in r["staged"]}),
             config3=gate_config3("dist_nccl_multi_gpu", results, world),
             ba=gate_ba("dist_nccl_multi_gpu", results),
             **({"config5": gate_config5("dist_nccl_multi_gpu", results)}
                if world == 4 else {}), world_s=wall)
    else:
        emit("dist_nccl_multi_gpu", ran=False,
             reason=f"{gpus} GPU on this machine; an NCCL world needs one GPU a rank")

    tmp.cleanup()
    return totals


def main():
    """Every phase."""
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
    from slr_torch.kernels import obj_text as ot
    from slr_torch.kernels import pose_graph as kpg
    from slr_torch.kernels import unwrap_scan as us
    from slr_torch.kernels import wavefront as wf
    from slr_torch.kernels.build import build_library
    from slr_torch.observability import HBM_GBPS
    from slr_torch.pipeline.reconstruct import (
        SPATIAL_MODES, DenseReconstructor, accumulate_by_projector, spatial_repair)
    from slr_torch.synth.render import default_rig, quantize_frames, render_scan
    from slr_torch.synth.scene import bumps_depth, checker_albedo

    kernel = fs.fused_decode_triangulate
    kernel_hdr = fs.fused_decode_triangulate_hdr
    dev = torch.device("cuda")
    dec = DecodeConfig()
    # points_max_abs_err (K1, K2), |dPhi| (K3-K5) of every comparison
    errs = {"k1": [], "k2": [], "k3": [], "k4": [], "k5": []}

    counts_of = launches_of

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

    def k1_path(name, frames, cam, proj, cfg, scan, rms_gate, recorded=None, **fields):
        """Kernel vs plain, then the path through DenseReconstructor: exactly
        one K1 launch, finite points of the right shape, RMS under the gate
        (and, where ``recorded``, equal to the recorded digits)."""
        a = versus_plain(frames, cam, proj, cfg, name)
        model = DenseReconstructor(cam, proj, cfg).to(dev)
        cloud, n1, n2 = counted(lambda: model(frames))
        check((n1, n2) == (1, 0), f"{name}: K1/K2 launched {n1}/{n2} times")
        check(tuple(cloud.points.shape) == (CAM_H, CAM_W, 3)
              and bool(torch.isfinite(cloud.points).all()), f"{name} points")
        rms, n = rms_vs_truth(cloud.points, cloud.mask, scan)
        check(rms <= rms_gate, f"{name}: RMS {rms} mm > {rms_gate}")
        check(recorded is None or f"{rms:.4f}" == recorded,
              f"{name}: RMS {rms} mm, recorded {recorded}")
        emit(name, launches=n1, rms_mm=rms, rms_gate_mm=rms_gate,
             valid_points=n, frames=list(frames.shape), dtype=str(frames.dtype),
             kernel_vs_plain=a, **fields)
        return n1

    # phase 2: build the kernels from the checkout's sources (set-up time),
    # one nvcc per source, all at once
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = dict(zip(LIBRARIES, pool.map(build_library, LIBRARIES)))
    for module in (fs, us, kb, kx, ot, kpg):   # load and type each library
        module.library()
    def ptxas_of(name):
        return ptxas_summary(built[name][1])

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
                        recorded=K1_UINT8_RMS_RECORDED, bytes=(20 + 28) * CAM_H * CAM_W)

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

    # phase 8b: the integer kernel's layouts against its plain version: rows
    # whose byte count is not a multiple of 16 and an aligned width with a
    # partial 128-column box (both decoded from device memory, not staged),
    # a uint8 stack 3 bytes into its buffer (contiguous, no 16-byte copy
    # takes it), and 12-bit data at full size
    layouts = {}

    def layout_device_ms(f, lcam, lproj, lcfg):
        """K1's device time on uint8 frames ``f`` (CUDA-graph replay)."""
        prm = fs.scan_params(lcam, lproj, lcfg, dec, (1.0, 1e4), 8, *f.shape[-2:],
                             dtype=torch.uint8)
        return statistics.median(graph_ms(lambda: fs.launch_fused_scan(f, prm)))

    for w in K1_LAYOUT_WIDTHS:
        lcam, lproj = default_rig(cam_w=w, cam_h=215, proj_w=256, proj_h=192,
                                  baseline=150.0, toe_in_deg=14.0, device=dev)
        lscan = render_scan(lcam, lproj, bumps_depth(215, w, base=480.0, amp=20.0,
                                                     device=dev), rcfg)
        f8 = quantize_frames(lscan.frames)
        layouts[f"uint8_{w}x215"] = versus_plain(f8, lcam, lproj, rcfg, f"uint8 {w}x215")
        layouts[f"uint8_{w}x215"]["device_ms"] = layout_device_ms(f8, lcam, lproj, rcfg)
        layouts[f"uint16_{w}x215"] = versus_plain(
            torch.clamp(torch.round(lscan.frames * m12), 0, m12).to(torch.uint16),
            lcam, lproj, rcfg, f"uint16 {w}x215", bit_depth=12)
    layouts["uint8_300x215_device_ms"] = layout_device_ms(
        quantize_frames(rscan.frames), rcam, rproj, rcfg)
    buf = torch.empty(frames8.numel() + 3, dtype=torch.uint8, device=dev)
    buf[3:] = frames8.reshape(-1)
    frames8_off = buf[3:].view(frames8.shape)
    check(frames8_off.is_contiguous() and frames8_off.data_ptr() % 4 == 3, "offset stack")
    layouts["uint8_offset3"] = versus_plain(frames8_off, cam_d, proj_d, cfg, "uint8 offset 3")
    layouts["uint8_offset3"]["device_ms"] = layout_device_ms(frames8_off, cam_d, proj_d, cfg)
    frames16 = torch.clamp(torch.round(frames * m12), 0, m12).to(torch.uint16)
    layouts["uint16_1280x1024"] = versus_plain(frames16, cam_d, proj_d, cfg,
                                               "uint16 1280x1024", bit_depth=12)
    emit("k1_integer_layouts", **layouts)

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

    # phase 12b: projector optics on the config-3 scene, defocus (a PSF of
    # 1 projector px) and gamma 2.2, decoded by K1: the modulation falls by
    # the closed form's factor (within 5 %, tests/test_synth.py:168-220's
    # rule), the accuracy holds (the config-3 gate)
    from slr_torch.synth.render import _fringe_series
    scan_o = render_scan(cam_d, proj_d, depth, cfg, noise_std=0.005,
                         generator=torch.Generator(device="cuda").manual_seed(0), **OPTICS)
    q_sharp, q_optics = (decode_stack(f, cfg, dec) for f in (frames, scan_o.frames))
    both = q_sharp.mask & q_optics.mask & scan_o.mask_true
    ratio = float((q_optics.quality[both] / q_sharp.quality[both]).median())
    expect = _fringe_series(cfg.fringe_pitch, OPTICS["proj_gamma"],
                            OPTICS["defocus_sigma"])[1][0][1] / 0.5
    check(abs(ratio - expect) < 0.05 * expect,
          f"defocus/gamma: modulation ratio {ratio}, closed form {expect}")
    launches += k1_path("k1_defocus_gamma", scan_o.frames, cam_d, proj_d, cfg, scan_o,
                        RMS_GATE_MM, optics=OPTICS, modulation_ratio=ratio,
                        modulation_ratio_closed_form=expect,
                        valid_vs_sharp=float(q_optics.mask.sum() / q_sharp.mask.sum()))

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
    # K2's layouts against its plain version, both fusions, each RMS against
    # the truth: a bracket whose chosen exposure changes inside most 128 x 2
    # boxes (squares ~3 px wide), 12-bit data in uint16, float32, 215 rows of
    # 299 and 301 pixels (rows no 16-byte copy takes), and the bracket 3 bytes
    # off 16-byte alignment
    def make_bracket(b_scan, gen_seed=9):
        g = torch.Generator(device="cuda").manual_seed(gen_seed)
        return torch.stack([torch.clamp(b_scan.frames * gain + 0.003 * torch.randn(
            b_scan.frames.shape, generator=g, device=dev), 0.0, 1.0) for gain in HDR_GAINS])

    scan_mix = render_scan(cam_d, proj_d, depth, cfg, albedo=checker_albedo(
        CAM_H, CAM_W, cells=CAM_W // 3, lo=0.035, hi=0.75, device=dev))
    bracket_mix = quantize_frames(make_bracket(scan_mix))
    float_h = make_bracket(scan_h)
    buf = torch.empty(bracket.numel() + 3, dtype=torch.uint8, device=dev)
    buf[3:] = bracket.reshape(-1)
    bracket_off = buf[3:].view(bracket.shape)
    check(bracket_off.is_contiguous() and bracket_off.data_ptr() % 4 == 3, "offset bracket")
    hdr_cases = [("mixed_boxes", bracket_mix, cam_d, proj_d, cfg, scan_mix, {}),
                 ("uint16_bit_depth_12", torch.clamp(torch.round(float_h * m12), 0, m12).to(
                     torch.uint16), cam_d, proj_d, cfg, scan_h, dict(bit_depth=12)),
                 ("float32", float_h, cam_d, proj_d, cfg, scan_h, {}),
                 ("uint8_offset3", bracket_off, cam_d, proj_d, cfg, scan_h, {})]
    for w in K1_LAYOUT_WIDTHS[:2]:
        lcam, lproj = default_rig(cam_w=w, cam_h=215, proj_w=256, proj_h=192,
                                  baseline=150.0, toe_in_deg=14.0, device=dev)
        lscan = render_scan(lcam, lproj, bumps_depth(215, w, base=480.0, amp=20.0, device=dev),
                            rcfg, albedo=checker_albedo(215, w, cells=6, lo=0.035, hi=0.75,
                                                        device=dev))
        hdr_cases.append((f"uint8_{w}x215", quantize_frames(make_bracket(lscan)), lcam, lproj,
                          rcfg, lscan, {}))
    hdr_layouts = {}
    for name, b, hcam, hproj, hcfg, hscan, kw in hdr_cases:
        case = {"bracket": list(b.shape), "dtype": str(b.dtype)}
        for fuse in ("sum", "select"):
            (o, n1, n2) = counted(lambda: kernel_hdr(b, hcam, hproj, hcfg, dec, fuse=fuse, **kw))
            check((n1, n2) == (0, 1), f"hdr {name} {fuse}: K1/K2 launched {n1}/{n2} times")
            a = agreement(o, fs.fused_decode_triangulate_hdr_reference(
                b, hcam, hproj, hcfg, dec, fuse=fuse, **kw))
            check_agreement(a, f"hdr {name} {fuse}")
            errs["k2"].append(a["points_max_abs_err"])
            rms_c, n_c = rms_vs_truth(o.points.movedim(0, -1), o.mask > 0.5, hscan)
            check(rms_c <= RMS_GATE_MM, f"hdr {name} {fuse}: RMS {rms_c} mm")
            case[fuse] = dict(kernel_vs_plain=a, rms_mm=rms_c, valid_points=n_c)
        chosen = box_exposures(hdr_best_exposure(b, hcfg, dec, **kw), len(HDR_GAINS), k2_box())
        case["boxes_mixed_share"] = float((chosen >= 2).float().mean())
        hdr_layouts[name] = case
    check(hdr_layouts["mixed_boxes"]["boxes_mixed_share"] > 0.5,
          "the mixed bracket's boxes agree")
    emit("k2_hdr_bracket", launches=launches_hdr, rms_mm=rms_h, valid_points=n_h,
         coverage_vs_best_single=coverage, best_single_valid=best_single,
         coverage_vs_best_single_k1=int(cloud_h.mask.sum()) / best_single_k1,
         bracket=list(bracket.shape), dtype=str(bracket.dtype),
         fuse=hdr, bytes=hdr_bytes, layouts=hdr_layouts)

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
    # the layouts and values K4's design has to take, K3 and K4 each against
    # the plain sweep bit for bit (the signs of zeros included) at 1 to 17
    # sweeps (9 and 17 take more than one K4 launch)
    k4_geometry = cu_constant("unwrap", "K4_RUN"), cu_constant("unwrap", "K4_WARPS")
    for name, (Phi_v, mask_v) in vote_maps(dev, phase_scene, *k4_geometry).items():
        q_v = torch.ones_like(Phi_v)
        for iters in VOTE_ITERS:
            plain = pu.spatial_quality_unwrap(Phi_v, q_v, mask_v, iters)
            k3 = us.launch_vote_resident(Phi_v, mask_v, iters)
            k4, n = counts_of(lambda: us.quality_unwrap_tiled(Phi_v, q_v, mask_v, iters))
            check(n["k4"] == -(-iters // us.MAX_HALO), f"K4 {name} iters {iters}: launches {n}")
            for k, got in (("k3", k3), ("k4", k4)):
                check(torch.equal(got.view(torch.int32), plain.view(torch.int32)),
                      f"{k.upper()} {name} iters {iters}: not bit-equal")
                errs[k].append(float((got - plain).abs().max()))
            voting[f"{name}_iters{iters}"] = dict(bit_equal=True, k4_launches=n["k4"],
                                                  moved=int((plain != Phi_v).sum()))
    # K3 alone on the largest maps the route rule sends it (1024x1024, and
    # 128x8192, its narrow, tall extreme: the most tiles), a 1280x800
    # camera's map, at 1, h, h + 1, 17 and 64 sweeps (h sweeps between two
    # exchanges of its tiles' rings: 64 sweeps, many exchanges); the last
    # of 20 launches back to back, no sync between; repairs crossing every
    # tile corner; and a 5 MP map, whose tiles no wave holds, refused
    k3_halo = cu_constant("unwrap", "K3_HALO")
    k3_wave, _, k3_ow, k3_oh = us.resident_layout(torch.cuda.current_device())
    for H, W in K3_MAPS:
        _, Phi_v, q_v, mask_v, _ = phase_scene(H, W, H + W, H * W // 500, partial=True)
        for iters in sorted({1, k3_halo, k3_halo + 1, 17, 64}):
            plain = pu.spatial_quality_unwrap(Phi_v, q_v, mask_v, iters)
            k3 = us.launch_vote_resident(Phi_v, mask_v, iters)
            torch.cuda.synchronize()
            check(torch.equal(k3.view(torch.int32), plain.view(torch.int32)),
                  f"K3 {W}x{H} iters {iters}: not bit-equal")
            errs["k3"].append(float((k3 - plain).abs().max()))
            voting[f"k3_{W}x{H}_iters{iters}"] = dict(
                bit_equal=True, tiles=us.resident_tiles(H, W, k3_ow, k3_oh),
                moved=int((plain != Phi_v).sum()))
    batch = [us.launch_vote_resident(Phi_v, mask_v, 8) for _ in range(K3_BATCH)]
    plain = pu.spatial_quality_unwrap(Phi_v, q_v, mask_v, 8)
    torch.cuda.synchronize()
    check(all(torch.equal(b.view(torch.int32), plain.view(torch.int32)) for b in batch),
          f"K3: {K3_BATCH} launches back to back differ from the plain sweep")
    voting[f"k3_{W}x{H}_batch{K3_BATCH}"] = dict(bit_equal=True)
    # repairs that cross every corner of K3's tiles, sweep after sweep
    k3_geometry = [cu_constant("unwrap", f"K3_{n}") for n in ("RUN", "WARPS", "HALO")]
    Phi_v, mask_v = (torch.from_numpy(a).to(dev)
                     for a in corner_fronts(K3_CAM_H, K3_CAM_W, *k3_geometry))
    for iters in (*range(1, 3 * k3_halo + 1), 17):
        plain = pu.spatial_quality_unwrap(Phi_v, None, mask_v, iters)
        k3 = us.launch_vote_resident(Phi_v, mask_v, iters)
        torch.cuda.synchronize()
        check(torch.equal(k3.view(torch.int32), plain.view(torch.int32)),
              f"K3 corner fronts iters {iters}: not bit-equal")
        voting[f"k3_corner_fronts_iters{iters}"] = dict(
            bit_equal=True, moved=int((plain != Phi_v).sum()))
    _, Phi_v, _, mask_v, _ = phase_scene(TILED_H, TILED_W, 3, 10)
    try:
        us.launch_vote_resident(Phi_v, mask_v, 4)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None, f"K3 took a {TILED_W}x{TILED_H} map past one wave")
    voting[f"k3_{TILED_W}x{TILED_H}_refused"] = refused
    # a map within the reference's budget whose tiles exceed one wave:
    # quality_unwrap takes K4, the plain sweep's bits; K3 still refuses it
    H, W = K3_OVERFLOW_MAP
    _, Phi_v, q_v, mask_v, _ = phase_scene(H, W, H + W, H * W // 500, partial=True)
    check(not us.takes_tiled(H, W) and us.resident_tiles(H, W, k3_ow, k3_oh) > k3_wave,
          f"{W}x{H}: not a map past one wave within the budget")
    got, n = counts_of(lambda: us.quality_unwrap(Phi_v, q_v, mask_v, 8))
    plain = pu.spatial_quality_unwrap(Phi_v, q_v, mask_v, 8)
    same = torch.equal(got.view(torch.int32), plain.view(torch.int32))
    check(same and n["k3"] == 0 and n["k4"] == 1,
          f"quality_unwrap {W}x{H}: launches {n}, bit-equal {same}")
    errs["k4"].append(float((got - plain).abs().max()))
    try:
        us.launch_vote_resident(Phi_v, mask_v, 8)
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None, f"K3 took the {W}x{H} map")
    voting[f"quality_unwrap_{W}x{H}"] = dict(
        route="K4", launches=n, bit_equal=same, k3_refused=refused,
        tiles=us.resident_tiles(H, W, k3_ow, k3_oh), wave_tiles=k3_wave,
        moved=int((plain != Phi_v).sum()))
    emit("k3_k4_voting", k3_halo=k3_halo, **voting)

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
        check(torch.equal(out, ref), f"{name}: not bit-equal, |dPhi| {err} rad")
        errs["k5"].append(err)
        wave[name] = dict(launches=n["k5"], max_abs_err=err, bit_equal=True,
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
    # K5 alone, both axes and directions, against the plain pass bit for
    # bit: a 5 MP map (columns of 2048: 4 a block), a ragged one, lines of
    # 1283 and 1037 (no multiple of 8 or 16; 6 columns a block), columns of
    # 9000 and rows of MAX_LINE (the 16-element build), and rows whose maps
    # start one float off a 16-byte boundary (no vector path)
    for H, W, off in K5_CASES:
        args = wave_maps(dev, H, W, seed=H + W, offset=off)
        for axis in (1, 0):
            for rev in (False, True):
                got = wf.launch_wavefront_pass(*args, axis, rev)
                want = pu.directional_pass(*args, axis, rev)
                err = float((got[0] - want[0]).abs().max())
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"K5 {H}x{W}+{off} axis {axis} reverse {rev}: not bit-equal, "
                      f"|dPhi| {err}")
                errs["k5"].append(err)
        wave[f"alone_{H}x{W}" + (f"_offset{off}" if off else "")] = dict(
            bit_equal=True, passes=4, done_after=float(got[1].float().mean()))
    # K5 rounds (x - ps) / 2pi by a reciprocal and one FMA correction: the
    # same bits as the IEEE division on every float32 input; the voting
    # kernels' rounding too, but for the sign of a zero
    k5_round, vote_round = wf.cycles_mismatches(dev)
    wave["cycles_mismatches_of_2e32"] = k5_round
    wave["vote_round_mismatches_of_2e32"] = vote_round
    check(k5_round == 0, "K5's rounding differs from the division")
    check(vote_round == 0, "K3's and K4's rounding differs from the division")
    emit("k5_wavefront", **wave)

    # phase 17: the spatial repair on the main path: DenseReconstructor with
    # spatial_iters=4 on the config-3 scan, both modes (K1 + K4, or K1 + K5
    # x 8), then the voting mode on a 320x256 camera (noise 0.01) and on a
    # 1280x800 camera (a 1 MP sensor: config 3's projector, patterns and
    # noise), whose maps take K3; the mask stays the unrepaired one; the
    # repaired pixels are those of the plain route (the same function on
    # the host)
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
    mp_cam, mp_proj = default_rig(K3_CAM_W, K3_CAM_H)
    mp_scan = render_scan(mp_cam.to(dev), mp_proj.to(dev), bumps_depth(
        K3_CAM_H, K3_CAM_W, base=480.0, amp=30.0, device=dev), cfg, noise_std=0.005,
        generator=torch.Generator(device="cuda").manual_seed(0))
    mp_name = f"voting_{K3_CAM_W}x{K3_CAM_H}"
    spatial_runs.append((mp_name, mp_cam, mp_proj, cfg, mp_scan.frames.contiguous(), mp_scan,
                         (1, 0, 0)))
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
        if mode == mp_name:   # the 1 MP decode's own map, timed below
            mp_map = (base.x_p * (2 * math.pi / pitch), base.quality, base.mask)
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
    params16 = fs.scan_params(cam_d, proj_d, cfg, dec, (1.0, 1e4), 8, CAM_H,
                              CAM_W, dtype=torch.uint16, bit_depth=12)
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
        "plain_uint16": lambda: fs.fused_decode_triangulate_reference(
            frames16, cam_d, proj_d, cfg, dec, bit_depth=12),
        "kernel_uint16": lambda: fs.launch_fused_scan(frames16, params16),
    }
    turns = [tuple(n + sfx for n in ("plain", "kernel", "scan", "scan", "kernel", "plain"))
             for sfx in ("", "_uint8", "_hdr")]
    turns.append(("plain_uint16", "kernel_uint16", "kernel_uint16", "plain_uint16"))
    # the spatial repair on the config-3 decode's own map: K3 and K4 at 4,
    # 8 and 17 sweeps, K3 at 4 and 8 on the 1280x800 decode's own map (a
    # map its route carries), one K5 pass along rows and along columns (the
    # repair's last level: every masked pixel eligible, the trusted ones
    # done), the 8-pass repair, and the forward in each mode
    base = model(frames)
    pitch = cfg.fringe_pitch
    Phi3, q3, m3 = base.x_p * (2 * math.pi / pitch), base.quality, base.mask
    phi3, trust3 = pu.repair_trust(Phi3, q3, m3)
    models = {mode: DenseReconstructor(cam, proj, cfg, DecodeConfig(
        spatial_unwrap_mode=mode), spatial_iters=SPATIAL_ITERS).to(dev)
        for mode in SPATIAL_MODES}
    for it in K3_TIMED_ITERS:
        runs.update({
            f"plain_vote{it}": lambda it=it: pu.spatial_quality_unwrap(Phi3, q3, m3, it),
            f"k3_{it}": lambda it=it: us.launch_vote_resident(Phi3, m3, it),
            f"k4_{it}": (lambda it=it: us.launch_vote_tiled(Phi3, m3, it)) if it <= us.MAX_HALO
            else (lambda it=it: us.quality_unwrap_tiled(Phi3, q3, m3, it))})
        turns.append((f"plain_vote{it}", f"k3_{it}", f"k4_{it}", f"k4_{it}",
                      f"k3_{it}", f"plain_vote{it}"))
    mp = f"{K3_CAM_W}x{K3_CAM_H}"
    for it in (SPATIAL_ITERS, 8):
        runs.update({
            f"plain_vote{it}_{mp}": lambda it=it: pu.spatial_quality_unwrap(*mp_map, it),
            f"k3_{it}_{mp}": lambda it=it: us.launch_vote_resident(mp_map[0], mp_map[2], it)})
        turns.append((f"plain_vote{it}_{mp}", f"k3_{it}_{mp}", f"k3_{it}_{mp}",
                      f"plain_vote{it}_{mp}"))
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
    moved = {"kernel": (4 * cfg.num_frames + 7 * 4) * px,
             "kernel_uint8": (cfg.num_frames + 7 * 4) * px,
             "kernel_uint16": (2 * cfg.num_frames + 7 * 4) * px,
             "kernel_hdr": hdr_bytes,
             # K3 and K4, the same sweeps: phi and mask in, the map out, each
             # once (K3's scratch map, whose sweeps between run in L2, and
             # K4's tiles' halo re-reads are the designs', K4's in
             # design_bytes)
             **{f"k{n}_{it}": (4 + 1 + 4) * px for n in (3, 4) for it in K3_TIMED_ITERS},
             **{f"k3_{it}_{mp}": (4 + 1 + 4) * K3_CAM_W * K3_CAM_H for it in (SPATIAL_ITERS, 8)},
             # K5: phi, Phi (4 B), elig, done (1 B) in; Phi, done out
             "k5_rows": 15 * px, "k5_cols": 15 * px}
    gbs = {f"{k}_gb_s": b / (ms[k] * 1e-3) / 1e9 for k, b in moved.items()}
    # what the designs read and write: K4 its tiles with their halos; K2
    # the frames every pixel reads, then the Gray frames of the exposures
    # each warp's 32-pixel row segment chose (whole boxes; config 3 has no
    # other); K2's boxes (128 x 2) and warp segments that chose more than one
    best = {k: hdr_best_exposure(b, cfg, dec)
            for k, b in (("kernel_hdr", bracket), ("kernel_hdr_mixed", bracket_mix))}
    design_bytes = {**{f"k4_{it}": k4_design_bytes(CAM_H, CAM_W, it, *k4_geometry)
                       for it in (SPATIAL_ITERS, 8)},
                    **{k: (len(HDR_GAINS) * (2 + cfg.phase_steps) + 7 * 4) * px
                       + int(box_exposures(m, len(HDR_GAINS), (1, 32)).sum())
                       * 2 * cfg.gray_bits * 32 for k, m in best.items()}}
    mixed_share = {f"{k}_{unit}": float((box_exposures(m, len(HDR_GAINS), box) >= 2)
                                        .float().mean())
                   for k, m in best.items()
                   for unit, box in (("boxes", k2_box()), ("warps", (1, 32)))}
    # the kernels alone on the device: CUDA-graph replays (K3's cooperative
    # launch too), median per launch, in turns
    runs["kernel_hdr_mixed"] = lambda: fs.launch_fused_scan_hdr(bracket_mix, params_h)
    params_hf = fs.scan_params(cam_d, proj_d, cfg, dec, (1.0, 1e4), 8, CAM_H, CAM_W,
                               exposures=len(HDR_GAINS))
    runs["kernel_hdr_float32"] = lambda: fs.launch_fused_scan_hdr(float_h, params_hf)
    device_runs = ("kernel", "kernel_uint8", "kernel_uint16", "kernel_hdr", "kernel_hdr_mixed",
                   "kernel_hdr_float32", *(f"k4_{it}" for it in K3_TIMED_ITERS), "k5_rows",
                   "k5_cols")
    k3_runs = (*(f"k3_{it}" for it in K3_TIMED_ITERS), f"k3_{SPATIAL_ITERS}_{mp}", f"k3_8_{mp}")
    device_times = {k: [] for k in (*device_runs, *k3_runs)}
    for _ in range(2):
        for k in (*device_runs, *k3_runs):
            device_times[k] += graph_ms(runs[k])
    device_ms = {k: statistics.median(v) for k, v in device_times.items()}
    host = {f"{k}_host_ms": host_ms(fn) for k, fn in (
        ("scan_params", lambda: fs.scan_params(cam_d, proj_d, cfg, dec,
                                               (1.0, 1e4), 8, CAM_H, CAM_W)),
        ("launch", runs["kernel"]), ("scan", runs["scan"]),
        *((k, runs[k]) for k in k3_runs))}
    emit("timing", card=card, runs_each=len(times["kernel"]),
         **{f"{k}_ms": v for k, v in ms.items()}, **host, **spread,
         **{f"{k}_device_ms": v for k, v in device_ms.items()},
         **{f"{k}_device_ms_spread": [min(v), max(v)] for k, v in device_times.items()},
         **{f"{k}_bytes": b for k, b in moved.items()}, **gbs,
         **{f"{k}_design_bytes": b for k, b in design_bytes.items()},
         **{f"{k}_mixed_share": v for k, v in mixed_share.items()},
         hbm_peak_gb_s=HBM_GBPS,
         **{k.replace("gb_s", "hbm_share"): v / HBM_GBPS for k, v in gbs.items()},
         after=nvidia_smi("clocks.sm,power.draw,temperature.gpu"))

    # phases 19-23: registration (config 4), K8
    k1_config5, orbit, config5_one, obj_entry, pg_entry, icp_entry, k8_entry = \
        registration_phases(dev, cam, proj, cfg, counts_of, card,
                            ptxas_summary(built["pose_graph"][1]), ptxas_summary(built["icp"][1]))
    launches += k1_config5

    # phases 24-30: the two-camera merge, K7 and K6
    k7_entry, k6_entry = two_camera_phases(dev, counts_of, card,
                                           ptxas_summary(built["crossing"][1]))

    # phases 31-33: calibration (config 2)
    calibration_phases(dev, counts_of, card)

    # phases 34-39: the product surface (slice 9)
    product_launches = product_phases(
        dev, counts_of, card, dict(cam=cam_d, proj=proj_d, cfg=cfg, cloud=cloud,
                                   frames=frames, frames8=frames8, bracket=bracket), orbit)

    # phases 40-43: the parallel tier (slr_torch.dist), ranks as subprocesses
    dist_launches = dist_phases(dev, card, dict(cam=cam_d, proj=proj_d, cfg=cfg, frames=frames,
                                                frames8=frames8, scan=scan), orbit,
                                config5_one)

    vote_instr = VOTE_INSTR_PER_PX_SWEEP * px * SPATIAL_ITERS
    # K3's launch on this card: cells a tile owns, the tiles one wave holds
    # and the tiles of the two timed maps
    k3_shape = {"tile_owned_cells": [k3_ow, k3_oh], "wave_tiles": k3_wave,
                "blocks_per_sm": k3_wave // torch.cuda.get_device_properties(
                    0).multi_processor_count,
                "tiles": us.resident_tiles(CAM_H, CAM_W, k3_ow, k3_oh),
                f"tiles_{mp}": us.resident_tiles(K3_CAM_H, K3_CAM_W, k3_ow, k3_oh)}
    # K5: the composes of the timed passes' trees on this run's map, and
    # every compose of the tree at full cost (a map all CHAIN)
    composes = {k: wave_tree_composes(m3, trust3, axis)
                for k, axis in (("k5_rows", 1), ("k5_cols", 0))}
    wave_instr = {k: a * WAVE_INSTR_CHAIN + b * WAVE_INSTR_CHAIN_KILL
                  for k, (a, b, _) in composes.items()}
    wave_instr_all = {k: c[2] * WAVE_INSTR_CHAIN for k, c in composes.items()}
    emit("wall", s=time.perf_counter() - wall_start)

    kernels = [{
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
        "ms_uint16": ms["kernel_uint16"],
        "plain_ms_uint16": ms["plain_uint16"],
        **bound(moved["kernel"]), "library_ms": None,
        "bound_ms_uint8": bound(moved["kernel_uint8"])["bound_ms"],
        "bound_ms_uint16": bound(moved["kernel_uint16"])["bound_ms"],
        "device_ms": device_ms["kernel"],
        "device_ms_uint8": device_ms["kernel_uint8"],
        "device_ms_uint16": device_ms["kernel_uint16"],
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
        "bytes": moved["kernel_hdr"],
        "design_bytes": design_bytes["kernel_hdr"],
        "boxes_mixed_share": mixed_share["kernel_hdr_boxes"],
        "warps_mixed_share": mixed_share["kernel_hdr_warps"],
        "device_ms": device_ms["kernel_hdr"],
        "device_ms_mixed_boxes": device_ms["kernel_hdr_mixed"],
        "device_ms_float32": device_ms["kernel_hdr_float32"],
        "bound_ms_float32": bound(4 * (moved["kernel_hdr"] - 7 * 4 * px) + 7 * 4 * px)["bound_ms"],
        "design_bytes_mixed_boxes": design_bytes["kernel_hdr_mixed"],
        "boxes_mixed_share_mixed_boxes": mixed_share["kernel_hdr_mixed_boxes"],
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
        "device_ms": device_ms[f"k3_{SPATIAL_ITERS}"],
        "device_ms_iters8": device_ms["k3_8"],
        "device_ms_iters17": device_ms["k3_17"],
        "bound_ms_iters8": bound(moved["k3_8"], 2 * vote_instr)["bound_ms"],
        f"device_ms_{mp}": device_ms[f"k3_{SPATIAL_ITERS}_{mp}"],
        f"device_ms_{mp}_iters8": device_ms[f"k3_8_{mp}"],
        f"ms_{mp}": ms[f"k3_{SPATIAL_ITERS}_{mp}"],
        f"plain_ms_{mp}": ms[f"plain_vote{SPATIAL_ITERS}_{mp}"],
        f"bound_ms_{mp}": bound(moved[f"k3_{SPATIAL_ITERS}_{mp}"],
                                vote_instr * K3_CAM_W * K3_CAM_H // px)["bound_ms"],
        "host_ms": host[f"k3_{SPATIAL_ITERS}_host_ms"],
        f"host_ms_{mp}": host[f"k3_{SPATIAL_ITERS}_{mp}_host_ms"],
        f"launches_{mp}": spatial[mp_name]["launches"]["k3"],
        "halo": k3_halo,
        **k3_shape,
        "registers": [v for k, v in ptxas_of("unwrap").items() if "vote_resident" in k],
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
        "bytes": moved[f"k4_{SPATIAL_ITERS}"],
        "design_bytes": design_bytes[f"k4_{SPATIAL_ITERS}"],
        "device_ms": device_ms[f"k4_{SPATIAL_ITERS}"],
        "device_ms_iters8": device_ms["k4_8"],
        "device_ms_iters17": device_ms["k4_17"],
        "registers": [v for k, v in ptxas_of("unwrap").items() if "vote_tiled" in k],
        "overflow_map": {k: voting[f"quality_unwrap_{K3_OVERFLOW_MAP[1]}x{K3_OVERFLOW_MAP[0]}"][k]
                         for k in ("route", "launches", "bit_equal", "tiles", "wave_tiles")},
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
        **bound(moved["k5_rows"], wave_instr["k5_rows"]), "library_ms": None,
        "bound_ms_cols": bound(moved["k5_cols"], wave_instr["k5_cols"])["bound_ms"],
        "bound_ms_all_inputs": bound(moved["k5_rows"], wave_instr_all["k5_rows"])["bound_ms"],
        "bound_ms_all_inputs_cols": bound(moved["k5_cols"],
                                          wave_instr_all["k5_cols"])["bound_ms"],
        "tree_composes": {k: dict(chain=a, chain_after_kill=b, of_tree=c)
                          for k, (a, b, c) in composes.items()},
        "device_ms": device_ms["k5_rows"],
        "device_ms_cols": device_ms["k5_cols"],
    }, k8_entry, k7_entry, k6_entry, obj_entry, pg_entry, icp_entry]
    # the session paths' and the ranks' launches join the main path's
    for key, entry in zip(("k1", "k2", "k3", "k4", "k5", "k8", "k7", "k6", "obj_text",
                           "pose_graph", "icp"), kernels):
        entry["launches"] += product_launches[key] + dist_launches.get(key, 0)
    icp_entry["launches_polish"] += (product_launches["icp_polish"]
                                     + dist_launches.get("icp_polish", 0))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        dist_rank(sys.argv[2:])
    else:
        main()
