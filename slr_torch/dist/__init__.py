"""slr_torch.dist — the parallel tier (port of ``slr.dist``).

Ported so far: the single-device Schur-complement bundle adjustment
(``ba.bundle_adjust_reference``), which ``ba_refine`` runs, and the batch
of scans on one device (``batch.batched_reconstruct``), which
``Session.reconstruct_all`` runs. The mesh, halo exchange, sharded
reconstruction, the batch sharded over GPUs, the distributed BA and its
recovery come with multi-GPU (ROADMAP queue 1, slice 8).
"""

from slr_torch.dist.ba import BAResult, bundle_adjust_reference
from slr_torch.dist.batch import batched_reconstruct
