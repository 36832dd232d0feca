"""slr_torch.kernels — kernels written by hand for Hopper, each beside its
plain PyTorch version (port of ``slr.kernels``)."""

from slr_torch.kernels.fused_scan import (
    FusedScanOut,
    fused_decode_triangulate,
    fused_decode_triangulate_reference,
)
