"""slr_torch.calib — batched Zhang calibration (port of ``slr.calib``).

Normalized-DLT homographies, Zhang's closed-form intrinsics, per-view
extrinsics, then a batched Levenberg-Marquardt refinement of every
parameter at once; the image front end detects chessboard corners and
lifts them into the projector through the decoded patterns. Small batched
linear algebra and image filtering in plain torch: no kernel of its own.
"""

from slr_torch.calib.board import board_object_points, synth_board_views
from slr_torch.calib.homography import homography_dlt
from slr_torch.calib.lm import lm_solve
from slr_torch.calib.zhang import (
    zhang_init_intrinsics,
    extrinsics_from_homography,
    calibrate_camera,
    CalibrationResult,
)
from slr_torch.calib.stereo import (
    stereo_calibrate, calibrate_projector, StereoResult, calib_result_to_numpy,
    calib_result_from_numpy,
)
from slr_torch.calib.corners import (
    detect_chessboard,
    corner_candidates,
    refine_subpix,
    order_corner_grid,
)
from slr_torch.calib.proj_corners import projector_corners_from_decode
from slr_torch.calib.pipeline import calibrate_from_images, ImageCalibResult
