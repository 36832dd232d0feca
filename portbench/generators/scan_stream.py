"""Traffic kind ``scan_stream``: a scanner head's stream of frame stacks
into ``slr_torch.pipeline.stream.reconstruct_stream``, one client in a
closed loop.

Set-up renders a pool of distinct uint8 stacks from the seed with the
frozen synth (each stack's scene depth and bump amplitude drawn within the
configuration's ranges, its sensor noise from the seed) and holds them in
pinned host memory, as a camera driver's DMA buffers. The window hands
them to the stream in turn, ``prefetch`` copies ahead, and waits on each
cloud as it is yielded; it stops handing stacks once ``seconds`` have
passed, and the stacks in flight finish inside the window.

Mix parameters: ``pool`` (distinct stacks), ``prefetch``,
``spatial_iters`` (0: no repair; else voting sweeps), ``profile_scans``
(scans in the traced slice).
"""

from __future__ import annotations

import random
import time

import torch

from portbench import program, stats
from portbench.frozen import synth
from portbench.reference import scan as ref
from slr_torch.pipeline.stream import reconstruct_stream


class Traffic:
    def __init__(self, cfg: dict, params: dict, seed: int, device):
        self.cfg, self.p, self.seed = cfg, params, seed
        self.device = torch.device(device)
        self.spans = {}

    # --- set-up ------------------------------------------------------------

    def setup(self):
        cfg, dev = self.cfg, self.device
        cam, pr, pat, sc = cfg["camera"], cfg["projector"], cfg["pattern"], cfg["scene"]
        H, W = cam["height"], cam["width"]
        self.cam, self.proj = synth.default_rig(W, H, pr["width"], pr["height"],
                                                pr["baseline_mm"], pr["toe_in_deg"], device=dev)
        g = torch.Generator(device=dev).manual_seed(self.seed)
        self.pool = []
        for _ in range(self.p["pool"]):
            u = torch.rand(2, generator=g, device=dev).tolist()
            lo, hi = sc["base_mm_range"]
            base = lo + (hi - lo) * u[0]
            lo, hi = sc["amp_mm_range"]
            amp = lo + (hi - lo) * u[1]
            depth = synth.bumps_depth(H, W, base=base, amp=amp, device=dev)
            r = synth.render_scan(self.cam, self.proj, depth, pr["width"], pr["height"],
                                  pat["gray_bits"], pat["phase_steps"],
                                  noise_std=sc["noise_std"], generator=g)
            stack = synth.quantize_u8(r.frames).cpu()
            self.pool.append(stack.pin_memory() if dev.type == "cuda" else stack)
        self.args = (program.camera(self.cam, dev), program.camera(self.proj, dev),
                     program.pattern_config(cfg), program.decode_config(cfg),
                     program.reconstruct_config(cfg))
        # every shape the window uses: two passes over the pool
        self._drive(2 * len(self.pool))

    def _stream(self, stacks):
        return reconstruct_stream(stacks, *self.args, prefetch=self.p["prefetch"],
                                  spatial_iters=self.p["spatial_iters"], device=self.device)

    def _wait(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _drive(self, n: int) -> int:
        """``n`` scans of the pool through one stream, each waited on."""
        stacks = (self.pool[i % len(self.pool)] for i in range(n))
        for _ in self._stream(stacks):
            self._wait()
        return n

    # --- the measured window ---------------------------------------------------

    def window(self, seconds: float, sync_spans: bool):
        """Scans back to back for ``seconds``; returns the end-to-end metrics
        and (attempted, failed)."""
        handed, latency = [], []
        rng = random.Random(self.seed)
        seen = [0] * len(self.pool)
        self.kept = [None] * len(self.pool)
        t0 = time.perf_counter()
        stop = t0 + seconds

        def source():
            i = 0
            while time.perf_counter() < stop:
                handed.append(time.perf_counter())
                yield self.pool[i % len(self.pool)]
                i += 1

        for i, cloud in enumerate(self._stream(source())):
            self._wait()
            latency.append(time.perf_counter() - handed[i])
            k = i % len(self.pool)
            seen[k] += 1
            if rng.random() * seen[k] < 1.0:      # a uniform sample per stack
                self.kept[k] = cloud
        t_end = time.perf_counter()
        n = len(latency)
        metrics = {"scans_per_s": stats.rate_per_s(n, t0, t_end),
                   "scan_p95_ms": stats.p95(latency) * 1e3}
        return metrics, len(handed), len(handed) - n

    def traced_slice(self) -> int:
        """The profiled piece of work: ``profile_scans`` scans."""
        with torch.profiler.record_function("portbench.scan_stream"):
            return self._drive(self.p["profile_scans"])

    def release(self):
        self.args = None

    def close(self):
        pass

    # --- correctness -------------------------------------------------------------

    def reference(self, k: int, tf32: bool = False):
        """The plain reference's cloud of pool stack ``k``, and with the
        repair, the cloud before it too: (cloud, cloud before the repair)."""
        cfg = self.cfg
        pat, rc = cfg["pattern"], cfg["reconstruct"]
        rig = ref.rig_of(self.cam, self.proj)
        frames = self.pool[k].to(self.device)
        out = ref.decode(frames, rig, pat["gray_bits"], pat["phase_steps"],
                         cfg["projector"]["width"], cfg["decode"], rc["min_depth"],
                         rc["max_depth"], tf32=tf32)
        before = out
        if self.p["spatial_iters"]:
            pitch = cfg["projector"]["width"] / (1 << pat["gray_bits"])
            out = ref.repair(out, rig, pitch, self.p["spatial_iters"], rc["min_depth"],
                             rc["max_depth"], tf32=tf32)
        return out, before

    def _compare(self, clouds) -> dict:
        """The worst, over the pool, of the share of disagreeing pixels and,
        with the repair, of the reference's repaired pixels missed."""
        tol = self.cfg["checks"]["tolerances"]
        out = {"off_pixel_share": 0.0}
        if self.p["spatial_iters"]:
            out["repair_miss_share"] = 0.0
        for k, got in enumerate(clouds):
            if got is None:            # a stack never sampled: a wholly wrong cloud
                out = {name: 1.0 for name in out}
                continue
            after, before = self.reference(k)
            out["off_pixel_share"] = max(out["off_pixel_share"],
                                         ref.off_pixel_share(got, after, tol))
            if self.p["spatial_iters"]:
                out["repair_miss_share"] = max(out["repair_miss_share"],
                                               ref.repaired_miss_share(got, before, after, tol))
        return out

    def readings(self) -> dict:
        """The numbers compared, over the sampled clouds, one from every
        stack of the pool."""
        return self._compare([None if c is None else
                              (c.points, c.mask, c.colors, c.quality, c.x_p) for c in self.kept])

    def control_readings(self) -> dict:
        """The control: the reference in TF32 put in the program's place."""
        return self._compare([tuple(self.reference(k, tf32=True)[0])
                              for k in range(len(self.pool))])
