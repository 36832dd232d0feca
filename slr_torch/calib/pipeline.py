"""Image-based calibration, end to end (port of ``slr/calib/pipeline.py``).

From pixels to a calibrated rig:

  1. detect chessboard corners on the white-lit capture of each view
     (``slr_torch.calib.corners``);
  2. decode the pattern stack captured on the board into per-pixel
     projector coords (``slr_torch.codec.decode_stack``; needs row and
     column phase);
  3. lift each sub-pixel corner into projector coordinates through a local
     homography over the valid decoded pixels
     (``slr_torch.calib.proj_corners``);
  4. batched Zhang + LM for the camera and the projector (an inverse
     camera), then the joint stereo refinement.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from slr_torch.calib.board import board_object_points
from slr_torch.calib.corners import detect_chessboard
from slr_torch.calib.proj_corners import projector_corners_from_decode
from slr_torch.calib.stereo import StereoResult, calibrate_projector, stereo_calibrate
from slr_torch.calib.zhang import calibrate_camera
from slr_torch.codec import decode_stack
from slr_torch.config import DecodeConfig, PatternConfig


class ImageCalibResult(NamedTuple):
    stereo: StereoResult
    cam_rms: torch.Tensor       # camera-only Zhang reprojection RMS (px)
    proj_rms: torch.Tensor      # projector-only Zhang reprojection RMS (px)
    corners_cam: torch.Tensor   # (V, N, 2) detected image corners
    corners_proj: torch.Tensor  # (V, N, 2) decoded projector corners


def calibrate_from_images(
    white_images: Sequence,        # V x (H, W) white-lit captures
    frame_stacks: Sequence,        # V x (F, H, W) pattern-stack captures
    cols: int, rows: int, square: float,
    cfg: PatternConfig,
    dec: DecodeConfig | None = None,
    lm_iters: int = 60,
) -> ImageCalibResult:
    """Calibrate the camera+projector rig from captured images alone, on
    the images' device."""
    if cfg.row_phase_steps == 0:
        raise ValueError(
            "projector calibration needs sub-pixel projector ROWS: use a "
            "PatternConfig with row_gray_bits > 0 and row_phase_steps > 0")
    dec = dec or DecodeConfig()
    uv_cam, uv_proj = [], []
    for white, frames in zip(white_images, frame_stacks):
        corners, _ = detect_chessboard(white, cols, rows)
        res = decode_stack(torch.as_tensor(frames), cfg, dec)
        pxy, ok = projector_corners_from_decode(res.x_p, res.y_p, res.mask, res.quality,
                                                corners)
        if not bool(torch.all(ok)):
            bad = int(torch.sum(~ok))
            raise ValueError(
                f"{bad} corners lack valid decoded support; capture the "
                "board deeper inside the projector frustum")
        uv_cam.append(corners)
        uv_proj.append(pxy)

    uv_cam = torch.stack(uv_cam)
    uv_proj = torch.stack(uv_proj)
    obj = board_object_points(cols, rows, square, uv_cam.device)
    cam_res = calibrate_camera(obj, uv_cam, lm_iters=lm_iters)
    proj_res = calibrate_projector(obj, uv_proj, lm_iters=lm_iters)
    st = stereo_calibrate(obj, uv_cam, uv_proj, cam_res, proj_res,
                          lm_iters=max(lm_iters, 80))
    return ImageCalibResult(stereo=st, cam_rms=cam_res.rms, proj_rms=proj_res.rms,
                            corners_cam=uv_cam, corners_proj=uv_proj)
