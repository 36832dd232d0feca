"""slr_torch.registration — multi-scan alignment (port of ``slr.registration``).

Coarse: FPFH descriptors and batched RANSAC. Fine: point-to-plane ICP,
whose correspondence search is the tiled exact search or, for dense clouds,
the voxel hash (on the CPU) or the sorted-band search (kernel K8, on the
card); and projective-association ICP on organized grids. Pose graph:
Gauss-Newton over SE(3). Fusion: ``voxel_downsample`` (the voxel merge) and
the outlier filters on the voxel hash. The Schur bundle adjustment is in
``slr_torch.dist.ba``.
"""

from slr_torch.registration.band import (
    BandTarget, band_nearest_neighbors, band_nn_sorted, build_band_target,
    suggest_b_max)
from slr_torch.registration.features import fpfh_features, ransac_align
from slr_torch.registration.filters import (
    knn_mean_distance, radius_outlier_removal, statistical_outlier_removal)
from slr_torch.registration.icp import ICPResult, icp_point_to_plane
from slr_torch.registration.nn import nearest_neighbors
from slr_torch.registration.normals import grid_normals
from slr_torch.registration.posegraph import PoseGraphResult, pose_graph_optimize
from slr_torch.registration.projective import icp_projective
from slr_torch.registration.voxel import build_voxel_hash, voxel_downsample, voxel_hash_nn
