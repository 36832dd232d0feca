"""Scan-session state (port of ``slr/pipeline/session.py``): config,
calibration, scans and derived products under one directory, every stage
a file, so any stage re-runs from disk. The files are the reference's
formats, so either package opens the other's session.

The session runs on the card unless the caller asks for the CPU
(``Session(root, device="cpu")``); without a card it raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import torch

from slr_torch.config import ScanConfig, load_config, save_config
from slr_torch.device import require_device
from slr_torch.geom.camera import Camera
from slr_torch.io import (
    load_calibration, load_stage, peek_stage, save_calibration, save_stage, write_ply)
from slr_torch.observability import log_event
from slr_torch.pipeline.reconstruct import (
    ScanCloud, accumulate_by_projector, reconstruct_dense, reconstruct_scan,
    reconstruct_scan_hdr)
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
        self.root.mkdir(parents=True, exist_ok=True)
        (self.root / "scans").mkdir(exist_ok=True)
        (self.root / "clouds").mkdir(exist_ok=True)
        cfg_path = self.root / "config.json"
        if config is not None:
            self.config = config
            save_config(config, cfg_path)
        elif cfg_path.exists():
            self.config = load_config(cfg_path)
        else:
            self.config = ScanConfig()
            save_config(self.config, cfg_path)
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
        """The device layout of ``config.dist``. None when the config is
        single-device, or when the machine has fewer GPUs than the layout
        asks for (logged as ``mesh_fallback``; every route then runs on one
        device). With enough GPUs it raises ``NotImplementedError``: the
        sharded routes come with multi-GPU (ROADMAP slice 8)."""
        d = self.config.dist
        n = d.pixel_tiles * d.map_blocks
        if n <= 1:
            return None
        available = torch.cuda.device_count() if self.device.type == "cuda" else 0
        if available < n:
            log_event("mesh_fallback", requested=n, available=available)
            return None
        raise NotImplementedError(f"Session.mesh: a layout over {n} GPUs (pixel_tiles x "
                                  "map_blocks) comes with multi-GPU, ROADMAP slice 8")

    # --- calibration ---
    def set_calibration(self, cam: Camera, proj: Camera, meta=None,
                        cam2: Optional[Camera] = None):
        self.cam, self.proj = cam.to(self.device), proj.to(self.device)
        self.cam2 = None if cam2 is None else cam2.to(self.device)
        self.calib_meta = meta or {}
        save_calibration(self.root / "calibration.json", cam, proj, meta, cam2=cam2)

    # --- scans ---
    def add_scan(self, frames, frames2=None) -> int:
        """``frames2`` stores the second camera's stack of the same shot
        (two-camera rig); ``reconstruct`` then takes the two-camera route."""
        idx = len(self.scan_paths())
        stage = dict(frames=frames)
        if frames2 is not None:
            stage["frames2"] = frames2
        save_stage(self.root / "scans" / f"scan_{idx:03d}.npz", **stage)
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
          1. HDR bracket (frames.ndim == 4) -> reconstruct_scan_hdr (K2).
             A bracket with a second camera raises ``ValueError``.
          2. two-camera (frames2 + cam2) -> reconstruct_two_camera.
          3. K1 serves the pattern and ``fused`` -> reconstruct_dense
             (K1; with ``spatial_iters`` K3/K4 or K5).
          4. else reconstruct_scan.
        The reference's pixel-tile route comes with multi-GPU (``mesh``)."""
        if self.cam is None:
            raise RuntimeError("calibrate or set_calibration first")
        frames, frames2 = self._load_scan_pair(idx)
        p = self.config.pattern
        self.mesh  # noqa: B018 -- logs the fallback of a multi-device layout
        if frames.dim() == 4 and frames2 is not None:
            raise ValueError(
                "scan %d has both an exposure bracket and a second-camera "
                "stack: HDR + two-camera is unsupported (capture the "
                "bracket per camera as separate scans instead)" % idx)
        if frames.dim() == 4:
            cloud = reconstruct_scan_hdr(
                frames, self.cam, self.proj, p, self.config.decode,
                self.config.reconstruct)
        elif frames2 is not None and self.cam2 is not None:
            # the projector's calibration does not enter the geometry
            cloud = reconstruct_two_camera(
                frames, frames2, self.cam, self.cam2, p,
                self.config.decode, self.config.reconstruct)
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
        save_stage(self.root / "clouds" / f"scan_{idx:03d}.npz", **stage)
        return cloud

    def reconstruct_all(self, fused: bool = True) -> int:
        """Reconstruct every captured scan in one batch
        (``batched_reconstruct``: one K1 launch a scan). Brackets and
        two-camera scans go through ``reconstruct`` one by one. Returns the
        number of scans reconstructed."""
        n = len(self.scan_paths())
        if n == 0:
            return 0
        self.mesh  # noqa: B018 -- logs the fallback of a multi-device layout
        scan0_ndim = len(peek_stage(self.scan_paths()[0])["frames"])
        if self.cam2 is not None or scan0_ndim == 4:
            for i in range(n):
                self.reconstruct(i, fused=fused)
            return n
        # imported here: slr_torch.dist.batch imports this package
        from slr_torch.dist.batch import batched_reconstruct

        p = self.config.pattern
        clouds = batched_reconstruct(
            torch.stack([self.load_scan(i) for i in range(n)]), self.cam, self.proj, p,
            self.config.decode, self.config.reconstruct,
            fused=fused and p.phase_steps > 0 and p.use_inverse)
        for i in range(n):
            save_stage(self.root / "clouds" / f"scan_{i:03d}.npz",
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
        round of edges at a time) from 4 clouds, else ``register_scans``;
        then, past 2 clouds, ``ba_refine`` with ``pg_iters`` iterations."""
        clouds = [self.load_cloud(i) for i in range(self.cloud_count())]
        self.mesh  # noqa: B018 -- logs the fallback of a multi-device layout
        rcfg = self.config.registration
        if len(clouds) >= 4:
            reg = register_scans_batched(clouds, rcfg, use_features=use_features,
                                         cam=self.cam, loop_closures=loop_closures)
        else:
            reg = register_scans(clouds, rcfg, use_features=use_features, cam=self.cam,
                                 loop_closures=loop_closures)
        if refine_ba and len(clouds) > 2:
            reg = ba_refine(clouds, reg, iters=rcfg.pg_iters)
        save_stage(self.root / "registration.npz", **reg._asdict())
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
        nv, nf = write_tsdf_mesh_obj(out, vol)
        log_event("fuse_mesh", n_verts=nv, n_faces=nf, voxel=voxel)
        return str(out)

    def fuse(self, capacity: int = 1 << 20) -> str:
        """Voxel-merge every registered scan and write ``fused.ply``."""
        clouds = [self.load_cloud(i) for i in range(self.cloud_count())]
        reg = self.load_registration()
        pts, val, col, n_vox = fuse_scans(clouds, reg, self.config.registration,
                                          capacity=capacity)
        out = self.root / "fused.ply"
        write_ply(out, pts, mask=val, colors=col.expand(col.shape[0], 3))
        return str(out)
