"""Traffic kind ``fusion_job``: whole fused models back to back, one client
in a closed loop; one job is one model a user gets from a multi-view scan.

Set-up renders ``orbits`` orbits of the configuration's rock field from the
seed with the frozen synth (the rig moved by the configuration's steps, each
scan's sensor noise drawn from the seed), keeps their uint8 stacks on the
card, and runs one job on each. A job, on one orbit:

1. ``slr_torch.dist.batched_reconstruct`` of its stacks;
2. with ``register``: ``register_scans_batched`` (features, the
   configuration's samples) and ``ba_refine``; without: the orbit's own rig
   poses handed over by ``registered_scans_from_numpy``, as a turntable's
   encoder gives them;
3. ``fuse_scans`` into the voxel cloud;
4. ``tsdf.fuse_tsdf`` into the volume;
5. ``tsdf.write_tsdf_mesh_obj`` to one file under the temporary directory,
   overwritten by every job (it extracts the mesh once).

Each stage is a span of the benchmark (its host wall; in the traced run
ending in a card sync). Mix parameters: ``orbits``, ``register``,
``profile_models`` (models in the traced slice).
"""

from __future__ import annotations

import os
import random
import tempfile
import time
import warnings
from contextlib import contextmanager

import numpy as np
import torch

from portbench import program, stats
from portbench.frozen import synth
from portbench.reference import fusion as judge
from portbench.reference import scan as ref
from slr_torch.config import RegistrationConfig
from slr_torch.dist import batched_reconstruct
from slr_torch.pipeline import registerfuse as rf
from slr_torch.pipeline import tsdf
from slr_torch.pipeline.reconstruct import ScanCloud


class Traffic:
    def __init__(self, cfg: dict, params: dict, seed: int, device):
        self.cfg, self.p, self.seed = cfg, params, seed
        self.device = torch.device(device)
        self.spans = {}
        self.sync_spans = False

    # --- set-up ------------------------------------------------------------

    def setup(self):
        cfg, dev = self.cfg, self.device
        cam, pr, pat, sc, orb = (cfg[k] for k in ("camera", "projector", "pattern", "scene", "orbit"))
        H, W = cam["height"], cam["width"]
        self.cam, self.proj = synth.default_rig(W, H, pr["width"], pr["height"],
                                                pr["baseline_mm"], pr["toe_in_deg"], device=dev)
        g = torch.Generator(device=dev).manual_seed(self.seed)
        self.poses = []
        for s in range(orb["scans"]):
            R_m = synth.so3_exp(torch.tensor(orb["rot_vec_per_scan"], device=dev) * s)
            t_m = torch.tensor(orb["t_mm_per_scan"], device=dev) * s
            self.poses.append((R_m, t_m))
        S = len(self.poses)
        self.encoder_poses = (np.stack([R.cpu().numpy() for R, _ in self.poses]),
                              np.stack([t.cpu().numpy() for _, t in self.poses]),
                              np.zeros(S - 1, np.float32), np.zeros((), np.float32))
        self.orbits = []
        for _ in range(self.p["orbits"]):
            stacks = []
            for R_m, t_m in self.poses:
                cam_s, proj_s = synth.move_rig(self.cam, self.proj, R_m, t_m)
                depth = synth.rocks_scene(cam_s, H, W, n=sc["rocks"], seed=sc["rocks_seed"])
                r = synth.render_scan(cam_s, proj_s, depth, pr["width"], pr["height"],
                                      pat["gray_bits"], pat["phase_steps"],
                                      noise_std=sc["noise_std"], generator=g)
                stacks.append(synth.quantize_u8(r.frames))
            self.orbits.append(torch.stack(stacks))
        self.args = (program.camera(self.cam, dev), program.camera(self.proj, dev),
                     program.pattern_config(cfg), program.decode_config(cfg),
                     program.reconstruct_config(cfg))
        fd, self.obj_path = tempfile.mkstemp(prefix="portbench_", suffix=".obj")
        os.close(fd)
        self.kept_path = self.obj_path[:-4] + "_kept.obj"
        for o in range(len(self.orbits)):
            self._job(o)
        self.spans = {}

    # --- one job -------------------------------------------------------------

    @contextmanager
    def _span(self, name: str):
        with torch.profiler.record_function("portbench." + name):
            t0 = time.perf_counter()
            yield
            if self.sync_spans and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def _job(self, o: int):
        cfg, dev = self.cfg, self.device
        cam, proj, pc, dc, rc = self.args
        with self._span("decode"):
            batch = batched_reconstruct(self.orbits[o], cam, proj, pc, dc, rc)
            clouds = [ScanCloud(*(x[i] for x in batch)) for i in range(len(self.poses))]
        if self.p["register"]:
            with self._span("register"):
                reg = rf.register_scans_batched(
                    clouds, RegistrationConfig(icp_sample_points=cfg["registration"]["icp_sample_points"]),
                    use_features=cfg["registration"]["use_features"], cam=cam)
            with self._span("ba"):
                reg = rf.ba_refine(clouds, reg, n_landmarks=cfg["ba"]["landmarks"],
                                   iters=cfg["ba"]["iters"])
        else:
            reg = rf.registered_scans_from_numpy(*self.encoder_poses, device=dev)
        with self._span("fuse"):
            fused = self._fuse(clouds, reg)
        self._mesh(clouds, reg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return clouds, reg, fused

    def _fuse(self, clouds, reg):
        return rf.fuse_scans(clouds, reg, RegistrationConfig(voxel_size=self.cfg["fuse"]["voxel_mm"]),
                             capacity=self.cfg["fuse"]["capacity"])

    def _mesh(self, clouds, reg):
        """The TSDF of the registered clouds and its OBJ, written to the
        job's file."""
        with self._span("tsdf"):
            with warnings.catch_warnings():
                # the volume grows its voxel to hold the rock field, with a warning
                warnings.simplefilter("ignore")
                vol = tsdf.fuse_tsdf(clouds, self.args[0], reg.R, reg.t,
                                     size_vox=tuple(self.cfg["tsdf"]["size_vox"]),
                                     voxel=self.cfg["tsdf"]["voxel_mm"])
        with self._span("mesh_write"):
            tsdf.write_tsdf_mesh_obj(self.obj_path, vol)

    # --- the measured window ---------------------------------------------------

    def window(self, seconds: float, sync_spans: bool):
        """Whole models back to back until ``seconds`` have passed; the last
        model started finishes inside the window."""
        self.sync_spans = sync_spans
        rng = random.Random(self.seed)
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            o = n % len(self.orbits)
            out = self._job(o)
            n += 1
            if rng.random() * n < 1.0:            # a uniform sample of the models
                self.kept = (o, *out)
                os.replace(self.obj_path, self.kept_path)
        t_end = time.perf_counter()
        self.sync_spans = False
        return {"model_ms": stats.ms_per_item(n, t0, t_end)}, n, 0

    def traced_slice(self) -> int:
        for i in range(self.p["profile_models"]):
            self._job(i % len(self.orbits))
        return self.p["profile_models"]

    def release(self):
        self.args = None

    def close(self):
        for path in (self.obj_path, self.kept_path):
            if os.path.exists(path):
                os.remove(path)

    # --- correctness -------------------------------------------------------------

    def _ref_decode(self, o: int, s: int, tf32: bool) -> ref.Cloud:
        cfg = self.cfg
        pat, rc = cfg["pattern"], cfg["reconstruct"]
        return ref.decode(self.orbits[o][s], ref.rig_of(self.cam, self.proj),
                          pat["gray_bits"], pat["phase_steps"], cfg["projector"]["width"],
                          cfg["decode"], rc["min_depth"], rc["max_depth"], tf32=tf32)

    def _poses(self, reg):
        """The poses a model is judged under: the program's own after
        registration (themselves judged against the orbit), else the
        orbit's, which the job was handed."""
        if self.p["register"]:
            return list(reg.R), list(reg.t)
        return list(self.encoder_poses[0]), list(self.encoder_poses[1])

    def _reference(self, o: int, Rs, ts, tf32: bool = False):
        """The plain reference's model of orbit ``o`` under the poses:
        (decoded clouds, fused voxels, mesh); ``tf32`` the control's."""
        cfg = self.cfg
        clouds = [self._ref_decode(o, s, tf32) for s in range(len(self.poses))]
        fused = judge.voxel_fuse(clouds, Rs, ts, cfg["fuse"]["voxel_mm"],
                                 cfg["fuse"]["capacity"], tf32)
        rig = ref.rig_of(self.cam, self.proj)
        vol = judge.tsdf_volume(clouds, (rig.fx, rig.fy, rig.cx, rig.cy), Rs, ts,
                                tuple(cfg["tsdf"]["size_vox"]), cfg["tsdf"]["voxel_mm"],
                                tf32=tf32)
        return clouds, fused, judge.mesh(vol)

    def _compare(self, o: int, clouds, means, mesh, reg=None) -> dict:
        """The numbers compared for one model of orbit ``o``: its decoded
        ``clouds`` (tuples of points, mask, colors, quality, x_p), its
        fused voxel ``means`` (K, 3) and its ``mesh`` (None: unreadable),
        against the reference's under the judged poses; with ``reg`` (a
        registered job), its poses against the orbit."""
        tol = self.cfg["checks"]["tolerances"]
        Rs, ts = self._poses(reg)
        r_clouds, r_fused, r_mesh = self._reference(o, Rs, ts)
        out = {"off_pixel_share": max(ref.off_pixel_share(tuple(c), r, tol)
                                      for c, r in zip(clouds, r_clouds))}
        if self.p["register"]:
            errs = [judge.pose_error(reg.R[s], reg.t[s], *self.poses[s])
                    for s in range(len(self.poses))]
            out["pose_rot_deg"] = max(e[0] for e in errs)
            out["pose_t_mm"] = max(e[1] for e in errs)
        out["fused_off_share"] = judge.fused_off_share(means, r_fused, self.cfg["fuse"]["voxel_mm"],
                                                       tol["points_mm"])
        out.update(judge.mesh_readings(mesh, r_mesh, tol["points_mm"]))
        return out

    def _read_mesh(self, path):
        with open(path) as fh:
            return judge.read_obj(fh.read())

    def readings(self) -> dict:
        """The numbers compared, on the sampled model: its decoded clouds,
        fused voxels and OBJ mesh against the plain reference's; its poses
        against the orbit (registered jobs)."""
        o, clouds, reg, fused = self.kept
        return self._compare(o, clouds, fused[0][fused[1]], self._read_mesh(self.kept_path),
                             reg if self.p["register"] else None)

    def control_readings(self) -> dict:
        """The control: the reference in TF32 put in the program's place on
        the sampled model's orbit, under its poses."""
        o, _, reg, _ = self.kept
        Rs, ts = self._poses(reg)
        clouds, fused, mesh = self._reference(o, Rs, ts, tf32=True)
        out = self._compare(o, clouds, fused.means, mesh, reg if self.p["register"] else None)
        if self.p["register"]:                 # the control registers nothing
            del out["pose_rot_deg"], out["pose_t_mm"]
        return out

    def fault_readings(self) -> dict:
        """The numbers of the sampled model with a fault planted, each by
        name: ``half_scans``, the voxel fuse and the TSDF over the first half
        of the orbit; ``half_faces``, every second face of the OBJ left out;
        for registered jobs ``identity_poses``, registration left at its
        start; ``tf32_program``, a whole job with the program's matrix
        products in TF32. Needs the program: called before ``release``."""
        o, clouds, reg, fused = self.kept
        h = len(clouds) // 2
        half = reg._replace(R=reg.R[:h], t=reg.t[:h])
        out = {}
        f_half = self._fuse(clouds[:h], half)
        self._mesh(clouds[:h], half)
        out["half_scans"] = self._compare(o, clouds, f_half[0][f_half[1]],
                                          self._read_mesh(self.obj_path),
                                          reg if self.p["register"] else None)
        mesh = self._read_mesh(self.kept_path)
        halved = judge.Mesh(mesh.verts.reshape(-1, 3, 3)[::2].reshape(-1, 3), (mesh.faces + 1) // 2)
        out["half_faces"] = self._compare(o, clouds, fused[0][fused[1]], halved,
                                          reg if self.p["register"] else None)
        if self.p["register"]:
            errs = [judge.pose_error(torch.eye(3), torch.zeros(3), *self.poses[s])
                    for s in range(len(self.poses))]
            out["identity_poses"] = {"pose_rot_deg": max(e[0] for e in errs),
                                     "pose_t_mm": max(e[1] for e in errs)}
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            try:
                c32, r32, f32 = self._job(o)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            out["tf32_program"] = self._compare(o, c32, f32[0][f32[1]],
                                                self._read_mesh(self.obj_path), r32)
        return out
