"""slr_torch.synth — the subset of the synthetic virtual scanner that the
ported scan paths use (port of ``slr.synth``)."""

from slr_torch.synth.render import (
    RenderedScan, default_rig, move_rig, render_scan, two_camera_rig)
from slr_torch.synth.scene import (
    bumps_depth, checker_albedo, plane_depth, rocks_scene, sphere_depth,
    spheres_scene)
