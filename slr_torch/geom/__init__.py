"""slr_torch.geom — pinhole + distortion camera model and triangulation
(port of ``slr.geom``; SE(3) and DLT are later slices)."""

from slr_torch.geom.camera import (
    Camera,
    camera_from_numpy,
    distort,
    make_camera,
    pixel_to_ray,
    project,
    undistort_iterative,
)
from slr_torch.geom.triangulate import (
    triangulate_midpoint,
    triangulate_plane,
    triangulate_rays,
)
