"""slr_torch.synth — the synthetic virtual scanner (port of ``slr.synth``):
scenes, the pattern renderer with its optics, and the calibration board."""

from slr_torch.synth.render import (
    RenderedScan, default_rig, move_rig, render_scan, two_camera_rig)
from slr_torch.synth.scene import (
    bumps_depth, checker_albedo, plane_depth, rocks_scene, sphere_depth,
    spheres_scene)
from slr_torch.synth.board import BoardView, board_poses, render_board_view
