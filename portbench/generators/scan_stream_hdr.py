"""Traffic kind ``scan_stream_hdr``: a scanner head's stream of exposure
brackets into ``slr_torch.pipeline.stream.reconstruct_stream``, one client
in a closed loop: ``scan_stream``'s loop (``generators/scan_stream.py``),
with an (E, F, H, W) uint8 bracket in place of each stack.

Set-up renders a pool of distinct brackets from the seed with the frozen
synth and the frozen bracket renderer (``frozen/hdr.py``: each bracket's
scene depth and bump amplitude drawn within the configuration's ranges,
one noiseless render under the configuration's checkerboard albedo, then
an independent capture at each gain of ``hdr.gains`` with its own sensor
noise from the seed) and holds them in pinned host memory, as the camera's
DMA buffers. The window, the traced slice and the sampling of one kept
cloud a pool bracket are ``scan_stream``'s. Each kept cloud is judged
against the plain reference of the HDR fuse (``reference/hdr.py``).

Mix parameters: ``scan_stream``'s (``pool``, ``prefetch``,
``spatial_iters``, which has to be 0: a bracket has no repair,
``profile_scans``).
"""

from __future__ import annotations

import torch

from portbench import program
from portbench.frozen import hdr as frozen_hdr
from portbench.frozen import synth
from portbench.generators import scan_stream
from portbench.reference import hdr as ref
from portbench.reference import scan as ref_scan
from slr_torch.kernels.fused_scan import fused_decode_triangulate_hdr
from slr_torch.pipeline.reconstruct import reconstruct_scan_hdr


class Traffic(scan_stream.Traffic):
    # --- set-up ------------------------------------------------------------

    def setup(self):
        cfg, dev = self.cfg, self.device
        cam, pr, pat, sc, hdr = (cfg[k] for k in ("camera", "projector", "pattern", "scene",
                                                  "hdr"))
        if hdr["fuse"] != "sum":
            raise ValueError("the stream fuses a bracket by 'sum'")
        if hdr["saturation"] != 0.98:
            raise ValueError("the stream reconstructs a bracket at saturation 0.98")
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
            bracket = frozen_hdr.render_bracket(self.cam, self.proj, depth, pr["width"],
                                                pr["height"], pat["gray_bits"],
                                                pat["phase_steps"], hdr, generator=g).cpu()
            self.pool.append(bracket.pin_memory() if dev.type == "cuda" else bracket)
        self.args = (program.camera(self.cam, dev), program.camera(self.proj, dev),
                     program.pattern_config(cfg), program.decode_config(cfg),
                     program.reconstruct_config(cfg))
        # every shape the window uses: two passes over the pool
        self._drive(2 * len(self.pool))

    def traced_slice(self) -> int:
        """The profiled piece of work: ``profile_scans`` brackets."""
        with torch.profiler.record_function("portbench.scan_stream_hdr"):
            return self._drive(self.p["profile_scans"])

    # --- correctness -------------------------------------------------------------

    def reference(self, k: int, tf32: bool = False) -> ref_scan.Cloud:
        """The plain reference's cloud of pool bracket ``k``."""
        cfg = self.cfg
        pat, rc = cfg["pattern"], cfg["reconstruct"]
        return ref.decode_bracket(self.pool[k].to(self.device),
                                  ref_scan.rig_of(self.cam, self.proj), pat["gray_bits"],
                                  pat["phase_steps"], cfg["projector"]["width"], cfg["decode"],
                                  cfg["hdr"]["saturation"], rc["min_depth"], rc["max_depth"],
                                  tf32=tf32)

    def _compare(self, clouds) -> dict:
        """The worst, over the pool, of the share of pixels that disagree
        with the reference, and the fewest valid pixels of a cloud."""
        tol = self.cfg["checks"]["tolerances"]
        out = {"off_pixel_share": 0.0, "valid_pixels_min": None}
        for k, got in enumerate(clouds):
            if got is None:            # a bracket never sampled: a wholly wrong cloud
                out.update(off_pixel_share=1.0, valid_pixels_min=0)
                continue
            out["off_pixel_share"] = max(out["off_pixel_share"],
                                         ref_scan.off_pixel_share(got, self.reference(k), tol))
            n = int(got[1].sum())
            out["valid_pixels_min"] = n if out["valid_pixels_min"] is None else min(
                out["valid_pixels_min"], n)
        return out

    @staticmethod
    def _judged(c):
        return None if c is None else (c.points, c.mask, c.colors, c.quality, c.x_p)

    def readings(self) -> dict:
        """The numbers compared, over the sampled clouds, one from every
        bracket of the pool."""
        return self._compare([self._judged(c) for c in self.kept])

    def control_readings(self) -> dict:
        """The control: the reference in TF32 put in the program's place."""
        return self._compare([tuple(self.reference(k, tf32=True))
                              for k in range(len(self.pool))])

    def fault_readings(self) -> dict:
        """The numbers with a fault planted in the program's run, each by
        name: ``long_from_next``, the longest exposure taken from the next
        pool bracket; ``select``, K2's ``fuse="select"`` (the best exposure's
        phase alone) in place of the program's fuse; ``half_pixels``, the
        lower half of the rows dropped from each kept cloud. Needs the
        program: called before ``release``."""
        n = len(self.pool)
        cam, proj, pattern, dec, rec = self.args
        mixed, selected = [], []
        for k in range(n):
            bracket = self.pool[k].to(self.device)
            swapped = bracket.clone()
            swapped[-1] = self.pool[(k + 1) % n][-1].to(self.device)
            mixed.append(self._judged(reconstruct_scan_hdr(swapped, *self.args)))
            c = reconstruct_scan_hdr(bracket, *self.args)
            o = fused_decode_triangulate_hdr(bracket, cam, proj, pattern, dec, fuse="select",
                                             z_bounds=(rec.min_depth, rec.max_depth))
            selected.append(self._judged(c._replace(
                points=o.points.movedim(0, -1), mask=o.mask > 0.5, quality=o.quality,
                x_p=o.x_p)))
        halved = []
        for c in self.kept:
            if c is not None:
                keep = torch.ones_like(c.mask)
                keep[c.mask.shape[0] // 2:] = False
                c = c._replace(points=torch.where(keep[..., None], c.points, 0.0),
                               mask=c.mask & keep, quality=torch.where(keep, c.quality, 0.0))
            halved.append(self._judged(c))
        return {"long_from_next": self._compare(mixed), "select": self._compare(selected),
                "half_pixels": self._compare(halved)}
