"""slr_torch.kernels — kernels written by hand for Hopper, each beside its
plain PyTorch version (port of ``slr.kernels``)."""

from slr_torch.kernels.crossing import (
    crossing_bin_sum,
    crossing_bin_sum_reference,
    crossing_interp,
    crossing_interp_fused,
    crossing_interp_fused_reference,
)
from slr_torch.kernels.fused_scan import (
    FusedScanOut,
    fused_decode_triangulate,
    fused_decode_triangulate_hdr,
    fused_decode_triangulate_hdr_reference,
    fused_decode_triangulate_reference,
)
from slr_torch.kernels.unwrap_scan import quality_unwrap, quality_unwrap_tiled
from slr_torch.kernels.wavefront import wavefront_repair, wavefront_unwrap
