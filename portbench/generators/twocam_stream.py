"""Traffic kind ``twocam_stream``: a two-camera head's stream of stack
pairs into ``slr_torch.pipeline.reconstruct_two_camera`` (the projector-
space merge), one client in a closed loop.

Set-up renders a pool of distinct uint8 stack pairs from the seed with the
frozen two-camera synth (the configuration's scene, as a part in a fixture;
each pair's sensor noise from the seed) and holds them in pinned host
memory, as a camera driver's DMA buffers. The window hands the pairs over in turn: each scan copies both
stacks to the card (``non_blocking``, in line on the current stream), merges
them, and is done when the harness has waited on its cloud on the card, so
the copies count in its time. The program has no two-camera stream, so
nothing is copied ahead. The window stops handing pairs once ``seconds``
have passed.

Mix parameters: ``pool`` (distinct pairs), ``profile_scans`` (scans in the
traced slice).
"""

from __future__ import annotations

import random
import time

import torch

from portbench import program, stats
from portbench.frozen import twocam as synth
from portbench.reference import twocam as ref
from slr_torch.pipeline.twocam import reconstruct_two_camera


class Traffic:
    def __init__(self, cfg: dict, params: dict, seed: int, device):
        self.cfg, self.p, self.seed = cfg, params, seed
        self.device = torch.device(device)
        self.spans = {}
        self._truth = None

    # --- set-up ------------------------------------------------------------

    def setup(self):
        cfg, dev = self.cfg, self.device
        cam, pr, pat, sc = cfg["camera"], cfg["projector"], cfg["pattern"], cfg["scene"]
        H, W = cam["height"], cam["width"]
        if not sc["cast_shadows"]:
            raise ValueError("the frozen two-camera renderer casts shadows")
        self.cams = synth.two_camera_rig(W, H, pr["width"], pr["height"], cam["baseline_mm"],
                                         cam["toe_in_deg"], device=dev)
        c1, c2, proj = self.cams
        g = torch.Generator(device=dev).manual_seed(self.seed)
        depths = [synth.spheres_scene(c, H, W) for c in (c1, c2)]
        self.pool = []
        for _ in range(self.p["pool"]):
            pair = []
            for c, depth in zip((c1, c2), depths):
                r = synth.render_pair_scan(c, proj, depth, pr["width"], pr["height"],
                                           pat["gray_bits"], pat["row_gray_bits"],
                                           pat["phase_steps"], pat["row_phase_steps"],
                                           noise_std=sc["noise_std"], generator=g)
                stack = synth.quantize_frames(r.frames).cpu()
                pair.append(stack.pin_memory() if dev.type == "cuda" else stack)
            self.pool.append(tuple(pair))
        self.args = (program.camera(c1, dev), program.camera(c2, dev),
                     program.pattern_config(cfg), program.decode_config(cfg),
                     program.reconstruct_config(cfg))
        # every shape the window uses: two passes over the pool
        self._drive(2 * len(self.pool))

    def _scan(self, k: int):
        """Pool pair ``k`` to the card and through the merge."""
        f1, f2 = (s.to(self.device, non_blocking=True) for s in self.pool[k])
        return reconstruct_two_camera(f1, f2, *self.args, method=self.cfg["method"])

    def _wait(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _drive(self, n: int) -> int:
        """``n`` scans of the pool, each waited on."""
        for i in range(n):
            self._scan(i % len(self.pool))
            self._wait()
        return n

    # --- the measured window ---------------------------------------------------

    def window(self, seconds: float, sync_spans: bool):
        """Scans back to back for ``seconds``; returns the end-to-end metrics
        and (attempted, failed)."""
        latency = []
        rng = random.Random(self.seed)
        seen = [0] * len(self.pool)
        self.kept = [None] * len(self.pool)
        t0 = time.perf_counter()
        stop = t0 + seconds
        i = 0
        while time.perf_counter() < stop:
            k = i % len(self.pool)
            handed = time.perf_counter()
            cloud = self._scan(k)
            self._wait()
            latency.append(time.perf_counter() - handed)
            seen[k] += 1
            if rng.random() * seen[k] < 1.0:      # a uniform sample per pair
                self.kept[k] = cloud
            i += 1
        t_end = time.perf_counter()
        n = len(latency)
        metrics = {"scans_per_s": stats.rate_per_s(n, t0, t_end),
                   "scan_p95_ms": stats.p95(latency) * 1e3}
        return metrics, n, 0

    def traced_slice(self) -> int:
        """The profiled piece of work: ``profile_scans`` scans."""
        with torch.profiler.record_function("portbench.twocam_stream"):
            return self._drive(self.p["profile_scans"])

    def release(self):
        self.args = None

    def close(self):
        pass

    # --- correctness -------------------------------------------------------------

    def reference(self, k: int, tf32: bool = False) -> ref.Merged:
        """The plain reference's merged cloud of pool pair ``k``."""
        c1, c2, _ = self.cams
        f1, f2 = (s.to(self.device) for s in self.pool[k])
        return ref.merge(f1, f2, ref.rig_cam(c1), ref.rig_cam(c2), self.cfg, tf32=tf32)

    def truth(self):
        """The scene's ground truth on the projector grid, made once."""
        if self._truth is None:
            pr = self.cfg["projector"]
            self._truth = synth.proj_truth(self.cams[2], pr["width"], pr["height"])
        return self._truth

    def _compare(self, clouds) -> dict:
        """The worst, over the pool, of the share of cells that disagree
        with the reference, of the RMS against the ground truth, and of
        the count of valid cells."""
        tol = self.cfg["checks"]["tolerances"]
        out = {"off_cell_share": 0.0, "truth_rms_mm": 0.0, "valid_cells_min": None}
        for k, got in enumerate(clouds):
            if got is None:           # a pair never sampled: a wholly wrong cloud
                out.update(off_cell_share=1.0, truth_rms_mm=ref.NO_CELL_RMS_MM, valid_cells_min=0)
                continue
            out["off_cell_share"] = max(out["off_cell_share"],
                                        ref.off_cell_share(got, self.reference(k), tol))
            out["truth_rms_mm"] = max(out["truth_rms_mm"],
                                      ref.truth_rms_mm(got[0], got[1], self.truth()))
            n = int(got[1].sum())
            out["valid_cells_min"] = n if out["valid_cells_min"] is None else min(
                out["valid_cells_min"], n)
        return out

    @staticmethod
    def _judged(c):
        return None if c is None else (c.points, c.mask, c.colors, c.quality)

    def readings(self) -> dict:
        """The numbers compared, over the sampled clouds, one from every
        pair of the pool."""
        return self._compare([self._judged(c) for c in self.kept])

    def control_readings(self) -> dict:
        """The control: the reference in TF32 put in the program's place."""
        return self._compare([tuple(self.reference(k, tf32=True))
                              for k in range(len(self.pool))])

    def fault_readings(self) -> dict:
        """The numbers with a fault planted in the program's run, each by
        name: ``swapped_camera``, camera 2's stack taken from the next pool
        pair; ``half_cells``, the lower half of the projector rows dropped
        from each kept cloud. Needs the program: called before
        ``release``."""
        n = len(self.pool)
        swapped = []
        for k in range(n):
            f1 = self.pool[k][0].to(self.device)
            f2 = self.pool[(k + 1) % n][1].to(self.device)
            swapped.append(self._judged(
                reconstruct_two_camera(f1, f2, *self.args, method=self.cfg["method"])))
        halved = []
        for c in self.kept:
            if c is not None:
                keep = torch.ones_like(c.mask)
                keep[c.mask.shape[0] // 2:] = False
                c = c._replace(points=torch.where(keep[..., None], c.points, 0.0),
                               mask=c.mask & keep, quality=torch.where(keep, c.quality, 0.0))
            halved.append(self._judged(c))
        return {"swapped_camera": self._compare(swapped), "half_cells": self._compare(halved)}
