"""The seed axis over devices: one process per device, whole seeds per
process (``distributed``: the Gloo group; ``mesh``: a rank's part of the
mesh; ``sharding``: which lanes a rank holds and what crosses ranks;
``launch``: D local ranks in one command)."""

from zebra_tpu_torch.parallel.distributed import (
    broadcast_one_to_all,
    initialize_distributed,
)
from zebra_tpu_torch.parallel.mesh import Mesh, make_mesh
from zebra_tpu_torch.parallel.sharding import local_lanes

__all__ = ["Mesh", "broadcast_one_to_all", "initialize_distributed",
           "local_lanes", "make_mesh"]
