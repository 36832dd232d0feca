"""slr_torch.pipeline — single-scan reconstruction (port of ``slr.pipeline``)."""

from slr_torch.pipeline.reconstruct import (
    DenseReconstructor,
    ScanCloud,
    accumulate_by_projector,
    reconstruct_dense,
    reconstruct_scan,
)
