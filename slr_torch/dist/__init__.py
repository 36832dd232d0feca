"""slr_torch.dist — the parallel tier (port of ``slr.dist``), SPMD over
``torch.distributed``: one process a device, every rank passing the whole
input and getting the whole output back, the same bits on every rank.

Mesh axes:
- ``pixel_tile`` shards the rows of a scan; a halo exchange feeds the
  spatial repair across tiles;
- ``map_block`` shards scans and landmarks for the batch, registration and
  bundle adjustment; only the reduced Schur pose system crosses blocks.

Every collective is in ``slr_torch.dist.comm``, which counts them.
"""

from slr_torch.dist.ba import BAResult, bundle_adjust_reference, distributed_bundle_adjust
from slr_torch.dist.batch import batched_reconstruct
from slr_torch.dist.halo import halo_exchange_rows
from slr_torch.dist.mesh import Mesh, init_distributed, make_mesh
from slr_torch.dist.recovery import reshard_fragments, resume_ba
from slr_torch.dist.sharded import sharded_reconstruct, sharded_unwrap
