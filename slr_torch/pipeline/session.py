"""Scan-session state (port of ``slr/pipeline/session.py``): config,
calibration, scans and derived products under one directory, every stage
a file, so any stage re-runs from disk. The files are the reference's
formats, so either package opens the other's session.

The session runs on the card unless the caller asks for the CPU
(``Session(root, device="cpu")``); without a card it raises.

In a job of several processes (``slr_torch.dist.init_distributed``) every
rank opens the same session and calls the same methods in the same order;
``config.dist`` lays the ranks out as a mesh, the routes the reference
shards run sharded, every rank ends each call with the same result, and
only rank 0 writes the session's files, between two barriers (the
reference's single controller writes once). Every rank reads those files
back, so in a job across hosts the session's root must be on a filesystem
that every host shares.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from slr_torch.config import ScanConfig, load_config, save_config
from slr_torch.device import require_device
from slr_torch.dist import comm
from slr_torch.dist.mesh import make_mesh
from slr_torch.dist.sharded import sharded_reconstruct
from slr_torch.geom.camera import Camera
from slr_torch.io import (
    load_calibration, load_stage, peek_stage, save_calibration, save_stage, write_ply)
from slr_torch.observability import log_event
from slr_torch.pipeline.reconstruct import (
    ScanCloud, _white_color, accumulate_by_projector, is_bracket, reconstruct_dense,
    reconstruct_scan, reconstruct_scan_hdr)
from slr_torch.pipeline.checks import validate_cloud
from slr_torch.pipeline.registerfuse import (
    RegisteredScans, ba_refine, fuse_scans, register_scans, register_scans_batched)
from slr_torch.pipeline.tsdf import fuse_tsdf, write_tsdf_mesh_obj
from slr_torch.pipeline.twocam import reconstruct_two_camera
from slr_torch.registration import statistical_outlier_removal


class Session:
    """Directory-backed scan session.

    Layout:
        session/config.json          ScanConfig
        session/calibration.json     camera + projector (+ camera2)
        session/scans/scan_%03d.npz  captured frame stacks (frames[, frames2])
        session/clouds/scan_%03d.npz decoded organized clouds
        session/registration.npz     poses
        session/fused.ply            fused model
        session/fused_mesh.obj       TSDF mesh
    """

    def __init__(self, root, config: Optional[ScanConfig] = None, device="cuda"):
        self.device = require_device(device)
        self.root = Path(root)
        cfg_path = self.root / "config.json"
        # read before any rank writes: every rank sees the same file
        if config is None and cfg_path.exists():
            self.config, fresh = load_config(cfg_path), False
        else:
            self.config, fresh = config or ScanConfig(), True

        def init_files():
            for d in (self.root, self.root / "scans", self.root / "clouds"):
                d.mkdir(parents=True, exist_ok=True)
            if fresh:
                save_config(self.config, cfg_path)

        comm.rank0_writes(init_files)
        self._mesh = None
        self.cam: Optional[Camera] = None
        self.cam2: Optional[Camera] = None  # two-camera rig (optional)
        self.proj: Optional[Camera] = None
        self.calib_meta: dict = {}
        calib = self.root / "calibration.json"
        if calib.exists():
            self.cam, self.proj, self.calib_meta, self.cam2 = load_calibration(
                calib, with_cam2=True, device=self.device)

    @property
    def mesh(self):
        """The rank layout of ``config.dist``, built on first use over the
        process group's world (``make_mesh``; every rank must ask). None
        when the config is single-device, or when the world has fewer ranks
        than the layout (logged as ``mesh_fallback`` with the world's size;
        every route then runs unsharded on each rank). A world larger than
        the layout raises ``ValueError``."""
        if self._mesh is not None:
            return self._mesh
        d = self.config.dist
        n = d.pixel_tiles * d.map_blocks
        if n <= 1:
            return None
        available = comm.world()[1]
        if available < n:
            log_event("mesh_fallback", requested=n, available=available)
            return None
        self._mesh = make_mesh(pixel_tiles=d.pixel_tiles, map_blocks=d.map_blocks)
        return self._mesh

    def _save_stage(self, path, **arrays):
        comm.rank0_writes(lambda: save_stage(path, **arrays))

    # --- calibration ---
    def set_calibration(self, cam: Camera, proj: Camera, meta=None,
                        cam2: Optional[Camera] = None):
        self.cam, self.proj = cam.to(self.device), proj.to(self.device)
        self.cam2 = None if cam2 is None else cam2.to(self.device)
        self.calib_meta = meta or {}
        comm.rank0_writes(lambda: save_calibration(self.root / "calibration.json", cam, proj,
                                                   meta, cam2=cam2))

    # --- scans ---
    def add_scan(self, frames, frames2=None) -> int:
        """``frames2`` stores the second camera's stack of the same shot
        (two-camera rig); ``reconstruct`` then takes the two-camera route."""
        idx = len(self.scan_paths())
        stage = dict(frames=frames)
        if frames2 is not None:
            stage["frames2"] = frames2
        self._save_stage(self.root / "scans" / f"scan_{idx:03d}.npz", **stage)
        return idx

    def scan_paths(self):
        return sorted((self.root / "scans").glob("scan_*.npz"))

    def _on_device(self, a) -> torch.Tensor:
        """A stored array on the session's device, its dtype kept (a uint8
        stack stays uint8 into K1)."""
        return torch.from_numpy(a).to(self.device)

    def load_scan(self, idx: int, second: bool = False):
        d = load_stage(self.scan_paths()[idx])
        if second:
            return self._on_device(d["frames2"]) if "frames2" in d else None
        return self._on_device(d["frames"])

    def _load_scan_pair(self, idx: int):
        """Both cameras' stacks from one stage read."""
        d = load_stage(self.scan_paths()[idx])
        frames2 = self._on_device(d["frames2"]) if "frames2" in d else None
        return self._on_device(d["frames"]), frames2

    # --- reconstruction ---
    def reconstruct(self, idx: int, fused: bool = True,
                    spatial_iters: int = 0,
                    accumulate: bool = False) -> ScanCloud:
        """Decode + triangulate scan ``idx`` into an organized cloud.

        ``accumulate`` also bins the cloud onto the projector column grid
        and persists the accumulated grid beside the cloud.

        Route precedence (first match wins):
          1. HDR bracket (``is_bracket``) -> reconstruct_scan_hdr (K2).
             A bracket with a second camera, or with ``spatial_iters``,
             raises ``ValueError``.
          2. two-camera (frames2 + cam2) -> reconstruct_two_camera.
          3. a mesh with pixel tiles that divide the rows ->
             sharded_reconstruct (K1 a rank at its row offset; with
             ``spatial_iters`` the haloed sweeps, K3/K4).
          4. K1 serves the pattern and ``fused`` -> reconstruct_dense
             (K1; with ``spatial_iters`` K3/K4 or K5).
          5. else reconstruct_scan."""
        if self.cam is None:
            raise RuntimeError("calibrate or set_calibration first")
        frames, frames2 = self._load_scan_pair(idx)
        p = self.config.pattern
        mesh = self.mesh
        bracket = is_bracket(frames, spatial_iters)
        if bracket and frames2 is not None:
            raise ValueError(
                "scan %d has both an exposure bracket and a second-camera "
                "stack: HDR + two-camera is unsupported (capture the "
                "bracket per camera as separate scans instead)" % idx)
        if bracket:
            cloud = reconstruct_scan_hdr(
                frames, self.cam, self.proj, p, self.config.decode,
                self.config.reconstruct)
        elif frames2 is not None and self.cam2 is not None:
            # the projector's calibration does not enter the geometry
            cloud = reconstruct_two_camera(
                frames, frames2, self.cam, self.cam2, p,
                self.config.decode, self.config.reconstruct)
        elif (mesh is not None and mesh.shape["pixel_tile"] > 1
                and frames.shape[1] % mesh.shape["pixel_tile"] == 0):
            pts, mask, x_p, quality = sharded_reconstruct(
                frames, self.cam, self.proj, p, self.config.decode, mesh,
                spatial_iters=spatial_iters)
            cloud = ScanCloud(points=pts, mask=mask, colors=_white_color(frames),
                              quality=quality, x_p=x_p)
        elif fused and p.phase_steps > 0 and (p.use_inverse or p.coding == "multifreq"):
            cloud = reconstruct_dense(
                frames, self.cam, self.proj, p, self.config.decode,
                self.config.reconstruct, spatial_iters=spatial_iters,
                spatial_mode=self.config.decode.spatial_unwrap_mode)
        else:
            cloud = reconstruct_scan(
                frames, self.cam, self.proj, p, self.config.decode,
                self.config.reconstruct)
        rc = self.config.reconstruct
        if rc.checked:
            # fail loudly on NaN points or a near-empty mask
            validate_cloud(cloud, rc.min_valid_fraction).throw()
        if rc.sor_k > 0:
            H, W = cloud.mask.shape
            keep = statistical_outlier_removal(
                cloud.points.reshape(-1, 3), cloud.mask.reshape(-1),
                rc.sor_voxel, k=rc.sor_k, std_ratio=rc.sor_std_ratio).reshape(H, W)
            cloud = cloud._replace(mask=cloud.mask & keep)
        stage = cloud._asdict()
        if accumulate:
            acc_pts, acc_mask, acc_col = accumulate_by_projector(cloud, p.proj_width)
            stage.update(acc_points=acc_pts, acc_mask=acc_mask, acc_colors=acc_col)
        self._save_stage(self.root / "clouds" / f"scan_{idx:03d}.npz", **stage)
        return cloud

    def reconstruct_all(self, fused: bool = True) -> int:
        """Reconstruct every captured scan in one batch
        (``batched_reconstruct``: one K1 launch a scan; with a mesh's map
        blocks, the batch padded to their count with copies of the last scan
        and split over them). Brackets, two-camera scans and a mesh with
        pixel tiles go through ``reconstruct`` one by one. Returns the
        number of scans reconstructed."""
        n = len(self.scan_paths())
        if n == 0:
            return 0
        mesh = self.mesh
        scan0_ndim = len(peek_stage(self.scan_paths()[0])["frames"])
        if self.cam2 is not None or scan0_ndim == 4 or (
                mesh is not None and mesh.shape["pixel_tile"] > 1):
            for i in range(n):
                self.reconstruct(i, fused=fused)
            return n
        # imported here: slr_torch.dist.batch imports this package
        from slr_torch.dist.batch import batched_reconstruct

        p = self.config.pattern
        frames = torch.stack([self.load_scan(i) for i in range(n)])
        pad = (-n) % (mesh.shape["map_block"] if mesh is not None else 1)
        if pad:
            frames = torch.cat([frames, frames[-1:].expand((pad,) + frames.shape[1:])])
        clouds = batched_reconstruct(
            frames, self.cam, self.proj, p, self.config.decode, self.config.reconstruct,
            mesh=mesh, fused=fused and p.phase_steps > 0 and p.use_inverse)
        for i in range(n):
            self._save_stage(self.root / "clouds" / f"scan_{i:03d}.npz",
                             **{k: v[i] for k, v in clouds._asdict().items()})
        return n

    def load_cloud(self, idx: int) -> ScanCloud:
        d = load_stage(self.root / "clouds" / f"scan_{idx:03d}.npz")
        return ScanCloud(*(self._on_device(d[k]) for k in ScanCloud._fields))

    def cloud_count(self) -> int:
        return len(list((self.root / "clouds").glob("scan_*.npz")))

    # --- registration + fusion ---
    def register(self, use_features: bool = True,
                 refine_ba: bool = True,
                 loop_closures: bool = True) -> RegisteredScans:
        """Align every reconstructed scan: ``register_scans_batched`` (one
        round of edges at a time) from 4 clouds or with a mesh of map
        blocks (the edges split over them), else ``register_scans``; then,
        past 2 clouds, ``ba_refine`` with ``pg_iters`` iterations (over the
        map blocks when there are any)."""
        clouds = [self.load_cloud(i) for i in range(self.cloud_count())]
        mesh = self.mesh
        if mesh is not None and mesh.shape["map_block"] <= 1:
            mesh = None
        rcfg = self.config.registration
        if len(clouds) >= 4 or mesh is not None:
            reg = register_scans_batched(clouds, rcfg, use_features=use_features,
                                         cam=self.cam, loop_closures=loop_closures,
                                         mesh=mesh)
        else:
            reg = register_scans(clouds, rcfg, use_features=use_features, cam=self.cam,
                                 loop_closures=loop_closures)
        if refine_ba and len(clouds) > 2:
            reg = ba_refine(clouds, reg, iters=rcfg.pg_iters, mesh=mesh)
        self._save_stage(self.root / "registration.npz", **reg._asdict())
        return reg

    def load_registration(self) -> RegisteredScans:
        d = load_stage(self.root / "registration.npz")
        return RegisteredScans(*(self._on_device(d[k]) for k in RegisteredScans._fields))

    def fuse_mesh(self, voxel: float = 2.0, size_vox=(128, 128, 128)) -> str:
        """TSDF-fuse all registered scans and export the extracted surface
        as OBJ, the volumetric counterpart of ``fuse``."""
        if self.cam is None:
            raise RuntimeError("calibrate or set_calibration first")
        clouds = [self.load_cloud(i) for i in range(self.cloud_count())]
        reg = self.load_registration()
        vol = fuse_tsdf(clouds, self.cam, reg.R, reg.t, size_vox=size_vox, voxel=voxel)
        out = self.root / "fused_mesh.obj"
        written = []
        comm.rank0_writes(lambda: written.extend(write_tsdf_mesh_obj(out, vol)))
        if written:
            log_event("fuse_mesh", n_verts=written[0], n_faces=written[1], voxel=voxel)
        return str(out)

    def fuse(self, capacity: int = 1 << 20) -> str:
        """Voxel-merge every registered scan and write ``fused.ply``."""
        clouds = [self.load_cloud(i) for i in range(self.cloud_count())]
        reg = self.load_registration()
        pts, val, col, n_vox = fuse_scans(clouds, reg, self.config.registration,
                                          capacity=capacity)
        out = self.root / "fused.ply"
        comm.rank0_writes(lambda: write_ply(out, pts, mask=val,
                                            colors=col.expand(col.shape[0], 3)))
        return str(out)
