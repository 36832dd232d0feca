"""slr_torch.pipeline — single-scan reconstruction, the two-camera merge,
multi-scan registration, bundle adjustment and fusion (configs 1-5), the
TSDF volume and its mesh, the organized-grid mesh, the streaming executor,
the checks, and ``Session``, the directory-backed product surface (port of
``slr.pipeline``)."""

from slr_torch.pipeline.reconstruct import (
    DenseReconstructor,
    ScanCloud,
    accumulate_by_projector,
    reconstruct_dense,
    reconstruct_scan,
    reconstruct_scan_hdr,
    scan_cloud_from_numpy,
)
from slr_torch.pipeline.meshing import grid_faces, write_mesh_obj
from slr_torch.pipeline.registerfuse import (
    RegisteredScans, ba_refine, fuse_scans, register_scans, register_scans_batched,
    registered_scans_from_numpy)
from slr_torch.pipeline.tsdf import (
    TSDFVolume, extract_mesh, fuse_tsdf, make_volume, tsdf_integrate, volume_from_numpy,
    write_tsdf_mesh_obj)
from slr_torch.pipeline.twocam import match_via_projector, reconstruct_two_camera
from slr_torch.pipeline.stream import reconstruct_stream
from slr_torch.pipeline.session import Session
from slr_torch.pipeline.checks import checked_reconstruct, nan_guard
