"""slr_torch.pipeline — single-scan reconstruction, the two-camera merge and
multi-scan registration (port of ``slr.pipeline``)."""

from slr_torch.pipeline.reconstruct import (
    DenseReconstructor,
    ScanCloud,
    accumulate_by_projector,
    reconstruct_dense,
    reconstruct_scan,
    reconstruct_scan_hdr,
    scan_cloud_from_numpy,
)
from slr_torch.pipeline.registerfuse import RegisteredScans, register_scans
from slr_torch.pipeline.twocam import match_via_projector, reconstruct_two_camera
