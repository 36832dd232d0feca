"""Calibration persistence as JSON (port of ``slr/io/calibio.py``).

The file is the reference's byte for byte for the same camera values:
each scalar is ``float`` of the same float32 value and each array the
float32 values' ``tolist``.
"""

from __future__ import annotations

import json

import numpy as np

from slr_torch.device import require_device
from slr_torch.geom.camera import Camera, make_camera
from slr_torch.io.checkpoint import as_numpy


def _cam_dict(cam: Camera) -> dict:
    return {
        "fx": float(cam.fx), "fy": float(cam.fy),
        "cx": float(cam.cx), "cy": float(cam.cy),
        "dist": as_numpy(cam.dist).tolist(),
        "R": as_numpy(cam.R).tolist(),
        "t": as_numpy(cam.t).tolist(),
    }


def _cam_from(d: dict, device) -> Camera:
    return make_camera(
        d["fx"], d["fy"], d["cx"], d["cy"],
        dist=np.asarray(d["dist"], np.float32),
        R=np.asarray(d["R"], np.float32),
        t=np.asarray(d["t"], np.float32),
        device=device,
    )


def save_calibration(path, cam: Camera, proj: Camera, meta: dict | None = None,
                     cam2: Camera | None = None):
    """``cam2`` persists the second camera of a two-camera rig."""
    d = {"camera": _cam_dict(cam), "projector": _cam_dict(proj),
         "meta": meta or {}}
    if cam2 is not None:
        d["camera2"] = _cam_dict(cam2)
    with open(path, "w") as f:
        json.dump(d, f, indent=2)


def load_calibration(path, with_cam2: bool = False, device="cuda"):
    """(camera, projector, meta[, camera 2 or None]) with the cameras'
    tensors on ``device``: the card unless the caller asks for the CPU;
    raises when asked for the card and there is none."""
    device = require_device(device)
    with open(path) as f:
        d = json.load(f)
    out = (_cam_from(d["camera"], device), _cam_from(d["projector"], device),
           d.get("meta", {}))
    if with_cam2:
        cam2 = _cam_from(d["camera2"], device) if "camera2" in d else None
        return out + (cam2,)
    return out
